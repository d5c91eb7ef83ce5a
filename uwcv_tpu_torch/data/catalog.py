"""Dataset & metadata catalogs (a copy of ``uwcv_tpu/data/catalog.py``).

Rebuilds the Detectron2 registries the reference wires at nn_train.py:185-193:
string-keyed lazy dataset thunks plus per-dataset metadata.  Kept deliberately
tiny — a dict of thunks and a dict of namespaces — but with the reference's
semantics (re-registration raises; thunks fire lazily and are cached).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}
        self._cache: Dict[str, List[dict]] = {}

    def register(self, name: str, func: Callable[[], List[dict]]) -> None:
        if name in self._registry:
            raise KeyError(f"dataset {name!r} already registered")
        self._registry[name] = func

    def get(self, name: str) -> List[dict]:
        if name not in self._registry:
            raise KeyError(
                f"dataset {name!r} not registered; available: {self.list()}")
        if name not in self._cache:
            self._cache[name] = self._registry[name]()
        return self._cache[name]

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str) -> None:
        self._registry.pop(name, None)
        self._cache.pop(name, None)

    def clear(self) -> None:
        self._registry.clear()
        self._cache.clear()


class _Metadata:
    """Attribute namespace; set-once like Detectron2 (changing a set value
    raises, setting the same value is a no-op)."""

    def __init__(self, name: str):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "_fields", {})

    def set(self, **kwargs) -> "_Metadata":
        for k, v in kwargs.items():
            fields = object.__getattribute__(self, "_fields")
            if k in fields and fields[k] != v:
                raise AttributeError(
                    f"metadata {k!r} of {self.name!r} already set to a "
                    f"different value")
            fields[k] = v
        return self

    def get(self, key: str, default=None):
        return object.__getattribute__(self, "_fields").get(key, default)

    def __getattr__(self, key: str):
        fields = object.__getattribute__(self, "_fields")
        if key in fields:
            return fields[key]
        raise AttributeError(f"metadata {key!r} not set on {self.name!r}")

    def __setattr__(self, key: str, value) -> None:
        self.set(**{key: value})

    def as_dict(self) -> dict:
        return dict(object.__getattribute__(self, "_fields"))


class _MetadataCatalog:
    def __init__(self):
        self._store: Dict[str, _Metadata] = {}

    def get(self, name: str) -> _Metadata:
        if name not in self._store:
            self._store[name] = _Metadata(name)
        return self._store[name]

    def clear(self) -> None:
        self._store.clear()


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()


def register_superannotate(
    name: str,
    img_dir: str,
    label_dir: Optional[str] = None,
    classes_csv: Optional[str] = None,
) -> None:
    """One-call equivalent of the reference's registration block
    (nn_train.py:185-193): register the lazy SA loader and set metadata
    (thing_classes/thing_colors keyed by classes.csv — fixing the reference's
    dead loader and its 'things_classes' typo, nn_inference.py:231-233)."""
    from uwcv_tpu_torch.data.classes import ClassRegistry
    from uwcv_tpu_torch.data.superannotate import get_superannotate_dicts

    registry = ClassRegistry.load(classes_csv)
    DatasetCatalog.register(
        name, lambda: get_superannotate_dicts(img_dir, label_dir, registry))
    MetadataCatalog.get(name).set(
        thing_classes=list(registry.names),
        thing_colors=list(registry.colors),
        class_keywords=list(registry.keywords),
    )


def register_coco(name: str, json_file: str, image_root: str) -> None:
    """Register a COCO-format dataset LAZILY — both the dataset dicts and
    the metadata parse the (possibly huge) annotations JSON only when first
    used, and registration works even before the file exists (the registry
    is declarative, like the reference's DatasetCatalog wiring
    nn_train.py:185-193)."""
    from uwcv_tpu_torch.data.coco import load_coco_json

    def load():
        dicts = load_coco_json(json_file, image_root)
        # metadata derived lazily alongside (once, on first use)
        if not MetadataCatalog.get(name).get("thing_classes"):
            import json as _json

            with open(json_file) as f:
                cats = sorted(_json.load(f).get("categories", []),
                              key=lambda c: c["id"])
            MetadataCatalog.get(name).set(
                thing_classes=[c["name"] for c in cats])
        return dicts

    DatasetCatalog.register(name, load)
