"""Minimal COCO-format annotation indexer (pycocotools-free).

Every reference dataset stores annotations as COCO-style JSON
({"images": [...], "annotations": [...]}) and indexes them with
pycocotools.coco.COCO (e.g. data/Human36M/dataset.py:163-186,
data/PW3D/dataset.py:104-166).  This is the same indexing without the
dependency: dict merges + id maps only.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

__all__ = ["CocoIndex"]


class CocoIndex:
    """Index over one or more merged COCO-style annotation dicts."""

    def __init__(self, dataset: Optional[dict] = None):
        self.dataset: dict = dataset or {}
        self.imgs: Dict[int, dict] = {}
        self.anns: Dict[int, dict] = {}
        self.img_anns: Dict[int, List[dict]] = {}
        if dataset:
            self.create_index()

    @classmethod
    def from_files(cls, paths: Iterable[str]) -> "CocoIndex":
        idx = cls()
        for p in paths:
            with open(p) as f:
                idx.merge(json.load(f))
        idx.create_index()
        return idx

    def merge(self, annot: dict) -> None:
        """Concatenate another annotation dict (list-valued keys extend,
        as the reference does for multi-subject H36M, dataset.py:170-176)."""
        if not self.dataset:
            self.dataset = {k: list(v) if isinstance(v, list) else v
                            for k, v in annot.items()}
            return
        for k, v in annot.items():
            if isinstance(v, list):
                self.dataset.setdefault(k, []).extend(v)
            else:
                self.dataset.setdefault(k, v)

    def create_index(self) -> None:
        self.imgs = {img["id"]: img for img in self.dataset.get("images", [])}
        self.anns = {ann["id"]: ann for ann in self.dataset.get("annotations", [])}
        self.img_anns = {}
        for ann in self.dataset.get("annotations", []):
            self.img_anns.setdefault(ann["image_id"], []).append(ann)

    def load_img(self, image_id: int) -> dict:
        return self.imgs[image_id]

    def anns_of(self, image_id: int) -> List[dict]:
        return self.img_anns.get(image_id, [])
