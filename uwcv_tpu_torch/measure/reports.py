"""Measurement sweep, analytics and reports (port of
``uwcv_tpu/measure/reports.py``) without pandas.

Per-class counts, window-3 moving averages, 10-bin histograms,
``ShapeDescriptor.csv``, ``Results<keyword>_.csv`` and distribution plots,
from one inference pass per image.  Descriptor rows are lists of floats,
and the CSVs are written with the stdlib ``csv`` module byte for byte as
pandas' ``DataFrame.to_csv(index=False)`` writes them for the JAX package:
``\\n`` line ends, minimal quoting, each float as its shortest round-trip
``repr``, NaN as an empty field, and a header-only file for a class with no
rows.  The plots keep their lazy matplotlib import.
"""

from __future__ import annotations

import csv
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from uwcv_tpu_torch.config import MeasureConfig
from uwcv_tpu_torch.data.classes import ClassRegistry
from uwcv_tpu_torch.measure.descriptors import (
    DESCRIPTOR_NAMES,
    ShapeDescriptors,
    measure_mask,
)


def moving_average(values: Sequence[float], window: int = 3) -> List[float]:
    """Trailing moving average, emitted once ``window`` samples exist
    (nn_inference.py:500-529 semantics)."""
    out = []
    buf: List[float] = []
    for v in values:
        buf.append(float(v))
        if len(buf) >= window:
            out.append(float(np.mean(buf[-window:])))
    return out


def _csv_field(v) -> str:
    """One value as pandas' ``to_csv`` writes it: floats by ``repr``, NaN
    empty, strings as they are."""
    if isinstance(v, str):
        return v
    v = float(v)
    return "" if math.isnan(v) else repr(v)


def write_csv(path: str, header: Sequence[str], rows: Sequence[Sequence]
              ) -> str:
    """``header`` and ``rows`` as ``DataFrame.to_csv(path, index=False)``
    writes them."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows([_csv_field(v) for v in row] for row in rows)
    return path


@dataclass
class ClassMeasurements:
    """Accumulated descriptors for one class over a folder of images."""

    class_name: str
    keyword: str
    rows: List[List[float]] = field(default_factory=list)
    count: int = 0                       # instances counted (C13)

    def add(self, descriptors: Sequence[ShapeDescriptors]):
        for d in descriptors:
            self.rows.append(d.as_row())

    def columns(self) -> Dict[str, np.ndarray]:
        """Descriptor name → float64 column over the rows."""
        table = np.asarray(self.rows, np.float64).reshape(
            len(self.rows), len(DESCRIPTOR_NAMES))
        return {c: table[:, i] for i, c in enumerate(DESCRIPTOR_NAMES)}

    def histograms(self, bins: int = 10) -> Dict[str, tuple]:
        if not self.rows:
            return {}
        return {c: np.histogram(v, bins=bins)
                for c, v in self.columns().items()}

    def moving_averages(self, window: int = 3) -> Dict[str, List[float]]:
        return {c: moving_average(v.tolist(), window)
                for c, v in self.columns().items()}


def measure_instances(
    instances_np: Dict[str, np.ndarray],
    class_id: int,
    cfg: MeasureConfig,
) -> List[ShapeDescriptors]:
    """Measure one image's predictions for one class: the selected instance
    masks are OR-ed into one canvas and measured (nn_inference.py:371-405)."""
    masks = instances_np.get("masks")
    if masks is None or len(masks) == 0:
        return []
    sel = instances_np["classes"] == class_id
    if not sel.any():
        return []
    canvas = np.any(masks[sel], axis=0)
    return measure_mask(canvas, cfg.pixels_per_metric, cfg.min_contour_area)


def count_instances(instances_np: Dict[str, np.ndarray],
                    num_classes: int) -> np.ndarray:
    """Per-class instance counts (0-based class ids)."""
    counts = np.zeros(num_classes, np.int64)
    for c in instances_np["classes"]:
        if 0 <= c < num_classes:
            counts[c] += 1
    return counts


class MeasurementReport:
    """Drives the per-class sweep over pre-computed predictions and writes
    the reference's artifact set."""

    def __init__(self, registry: ClassRegistry, cfg: MeasureConfig,
                 output_dir: str = "./output"):
        self.registry = registry
        self.cfg = cfg
        self.output_dir = output_dir
        self.per_class = [
            ClassMeasurements(n, k)
            for n, k in zip(registry.names, registry.keywords)
        ]
        self.total_counts = np.zeros(registry.num_classes, np.int64)
        os.makedirs(output_dir, exist_ok=True)

    def add_image(self, instances_np: Dict[str, np.ndarray]) -> None:
        """One prediction (all classes) — single inference pass reused."""
        self.total_counts += count_instances(
            instances_np, self.registry.num_classes)
        for cid, cm in enumerate(self.per_class):
            cm.add(measure_instances(instances_np, cid, self.cfg))
            cm.count = int(self.total_counts[cid])

    # ---------- artifacts ----------

    def write_shape_descriptor_csv(self) -> str:
        """ShapeDescriptor.csv: all classes concatenated with a Class column
        in front."""
        rows = [[cm.class_name, *r] for cm in self.per_class for r in cm.rows]
        return write_csv(os.path.join(self.output_dir, "ShapeDescriptor.csv"),
                         ["Class", *DESCRIPTOR_NAMES], rows)

    def write_results_csvs(self) -> List[str]:
        """Results<keyword>_.csv per class."""
        return [write_csv(os.path.join(self.output_dir,
                                       f"Results{cm.keyword}_.csv"),
                          DESCRIPTOR_NAMES, cm.rows)
                for cm in self.per_class]

    def summary(self) -> Dict[str, int]:
        """Console totals (nn_inference.py:541-558)."""
        return {cm.class_name: int(n)
                for cm, n in zip(self.per_class, self.total_counts)}

    def write_distribution_plots(self, columns: Optional[Sequence[str]] = None,
                                 kde: bool = True) -> List[str]:
        """Seaborn-style distribution plots (backup_main.py:600-613); needs
        matplotlib, and uses seaborn where it is installed."""
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError("write_distribution_plots needs matplotlib, "
                              "which is not installed") from e
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        try:
            import seaborn as sns
        except ImportError:
            sns = None

        columns = list(columns or DESCRIPTOR_NAMES)
        paths = []
        for cm in self.per_class:
            if not cm.rows:
                continue
            table = cm.columns()
            for col in columns:
                fig, ax = plt.subplots(figsize=(5, 4))
                data = table[col]
                if sns is not None:
                    sns.histplot(data, kde=kde and len(data) > 1, ax=ax,
                                 bins=self.cfg.histogram_bins)
                else:
                    ax.hist(data, bins=self.cfg.histogram_bins)
                ax.set_xlabel(col)
                ax.set_title(f"{cm.class_name}: {col}")
                slug = col.replace(" ", "_")
                path = os.path.join(self.output_dir,
                                    f"dist_{cm.keyword}_{slug}.png")
                fig.savefig(path, dpi=100, bbox_inches="tight")
                plt.close(fig)
                paths.append(path)
        return paths
