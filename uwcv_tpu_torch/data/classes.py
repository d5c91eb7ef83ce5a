"""Class registry driven by classes.csv (a copy of
``uwcv_tpu/data/classes.py``; stdlib ``csv`` only).

The reference loads classes.csv (columns ``className,red,green,blue``) into
``det_classes`` / ``det_colors`` at nn_train.py:166-180 but then never uses
them — classes stay hard-coded (README ToDo "fix measurements by classes.csv",
README.md:8).  Here the CSV is the actual source of truth: parsing, metadata,
measurement sweeps, and reports all key off this registry.  When no CSV is
given, the registry defaults to the reference's hard-coded 4-class set
(nn_train.py:108-117) with the inference colors (nn_inference.py:230-234).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

# Reference defaults: nn_train.py:108-117 (names) + nn_inference.py:230-234 (colors)
DEFAULT_CLASSES: Tuple[str, ...] = (
    "Scale bar",
    "Wall thickness of polyHIPEs",
    "Pore throats of polyHIPEs",
    "Pores of polyHIPEs",
)
DEFAULT_COLORS: Tuple[Tuple[int, int, int], ...] = (
    (115, 254, 248),
    (239, 254, 21),
    (146, 19, 26),
    (47, 213, 218),
)
# Short keywords used by the reference's measurement sweep (nn_inference.py:485)
DEFAULT_KEYWORDS: Tuple[str, ...] = ("Scale", "WThick", "PThroat", "Pore")


@dataclass
class ClassRegistry:
    names: List[str] = field(default_factory=lambda: list(DEFAULT_CLASSES))
    colors: List[Tuple[int, int, int]] = field(
        default_factory=lambda: list(DEFAULT_COLORS))
    keywords: List[str] = field(default_factory=lambda: list(DEFAULT_KEYWORDS))

    def __post_init__(self):
        if len(self.colors) < len(self.names):
            self.colors = list(self.colors) + [
                _auto_color(i) for i in range(len(self.colors), len(self.names))]
        if len(self.keywords) != len(self.names):
            self.keywords = [_keyword(n) for n in self.names]
        # keywords name per-class artifact files (Results<kw>_.csv) —
        # auto-derived keywords can collide for distinct class names
        # ("Red cell"/"Red cells" → "RedCell"), silently overwriting one
        # class's CSV with another's; suffix a counter on collision
        seen: dict = {}
        deduped = []
        for kw in self.keywords:
            if kw in seen:
                # bump until free: [A, A1, A] must not re-mint A1
                while True:
                    seen[kw] += 1
                    candidate = f"{kw}{seen[kw]}"
                    if candidate not in seen:
                        kw = candidate
                        break
            seen.setdefault(kw, 0)
            deduped.append(kw)
        self.keywords = deduped

    @property
    def num_classes(self) -> int:
        return len(self.names)

    def id_of(self, class_name: str) -> int:
        """Map an annotation className to a category id.

        Substring containment, mirroring the reference's matching
        (nn_train.py:108-115); raises ValueError on unknown names like the
        reference (nn_train.py:116-117).
        """
        for i, name in enumerate(self.names):
            if name in class_name:
                return i
        raise ValueError(f"Category Name Not Found: {class_name}")

    @classmethod
    def from_csv(cls, path: str) -> "ClassRegistry":
        """Load ``className,red,green,blue`` rows (nn_train.py:166-180 schema).

        A header row is detected and skipped if the color fields are
        non-numeric.
        """
        names: List[str] = []
        colors: List[Tuple[int, int, int]] = []
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if not row or not row[0].strip():
                    continue
                vals = [c.strip() for c in row]
                if len(vals) >= 4:
                    try:
                        rgb = (int(float(vals[1])), int(float(vals[2])),
                               int(float(vals[3])))
                    except ValueError:
                        continue  # header row
                    names.append(vals[0])
                    colors.append(rgb)
                elif len(vals) >= 1:
                    try:
                        float(vals[0])
                        continue
                    except ValueError:
                        names.append(vals[0])
                        colors.append(_auto_color(len(colors)))
        if not names:
            raise ValueError(f"no classes parsed from {path}")
        return cls(names=names, colors=colors, keywords=[_keyword(n) for n in names])

    @classmethod
    def load(cls, path: Optional[str]) -> "ClassRegistry":
        if path and os.path.exists(path):
            return cls.from_csv(path)
        return cls()

    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            for name, (r, g, b) in zip(self.names, self.colors):
                w.writerow([name, r, g, b])


def _keyword(name: str) -> str:
    """Short per-class keyword for file naming (reference uses hand-picked
    ["Scale","WThick","PThroat","Pore"], nn_inference.py:485)."""
    lowered = name.lower()
    mapping = {
        "scale bar": "Scale",
        "wall thickness of polyhipes": "WThick",
        "pore throats of polyhipes": "PThroat",
        "pores of polyhipes": "Pore",
    }
    if lowered in mapping:
        return mapping[lowered]
    return "".join(p[:1].upper() + p[1:4] for p in name.split()[:2]) or name


def _auto_color(i: int) -> Tuple[int, int, int]:
    # golden-ratio hue walk, deterministic
    import colorsys
    h = (i * 0.61803398875) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, 0.95)
    return (int(r * 255), int(g * 255), int(b * 255))
