"""Joint-set definitions shared by every dataset.

The reference duplicates these tuples in each data/<X>/dataset.py (e.g.
Human36M/dataset.py:39-77); here they live once.  A joint set = names +
skeleton edges + left/right flip pairs (+ extra graph edges for the MANO
joint graph, FreiHAND/dataset.py:40).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

__all__ = ["JointSet", "HUMAN36", "COCO", "SMPL_SET", "MANO_SET", "get_joint_set"]


@dataclass(frozen=True)
class JointSet:
    name: str
    joints_name: Tuple[str, ...]
    skeleton: Tuple[Tuple[int, int], ...]
    flip_pairs: Tuple[Tuple[int, int], ...] = ()
    extra_edges: Tuple[Tuple[int, int], ...] = ()
    root_joint: str = "Pelvis"

    @property
    def joint_num(self) -> int:
        return len(self.joints_name)

    @property
    def root_joint_idx(self) -> int:
        return self.joints_name.index(self.root_joint)

    @property
    def graph_flip_pairs(self) -> Tuple[Tuple[int, int], ...]:
        """Edges added to the joint graph beside the skeleton (the reference
        passes flip pairs — or for MANO the horizontal connections — as the
        second edge set of build_adj, graph_utils.py:63-72)."""
        return self.flip_pairs + self.extra_edges


HUMAN36 = JointSet(
    name="human36",
    joints_name=(
        "Pelvis", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee", "L_Ankle",
        "Torso", "Neck", "Nose", "Head", "L_Shoulder", "L_Elbow", "L_Wrist",
        "R_Shoulder", "R_Elbow", "R_Wrist",
    ),
    skeleton=(
        (0, 7), (7, 8), (8, 9), (9, 10), (8, 11), (11, 12), (12, 13),
        (8, 14), (14, 15), (15, 16), (0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6),
    ),
    flip_pairs=((1, 4), (2, 5), (3, 6), (14, 11), (15, 12), (16, 13)),
)

# 17 COCO keypoints + manually added Pelvis and Neck (Human36M/dataset.py:66-77)
COCO = JointSet(
    name="coco",
    joints_name=(
        "Nose", "L_Eye", "R_Eye", "L_Ear", "R_Ear", "L_Shoulder",
        "R_Shoulder", "L_Elbow", "R_Elbow", "L_Wrist", "R_Wrist", "L_Hip",
        "R_Hip", "L_Knee", "R_Knee", "L_Ankle", "R_Ankle", "Pelvis", "Neck",
    ),
    skeleton=(
        (1, 2), (0, 1), (0, 2), (2, 4), (1, 3), (6, 8), (8, 10), (5, 7),
        (7, 9), (12, 14), (14, 16), (11, 13), (13, 15),
        (17, 11), (17, 12), (17, 18), (18, 5), (18, 6), (18, 0),
    ),
    flip_pairs=(
        (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
    ),
)

SMPL_SET = JointSet(
    name="smpl",
    joints_name=(
        "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Knee", "R_Knee", "Spine",
        "L_Ankle", "R_Ankle", "Chest", "L_Toe", "R_Toe", "Neck", "L_Thorax",
        "R_Thorax", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
        "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
    ),
    skeleton=(
        (0, 1), (1, 4), (4, 7), (7, 10), (0, 2), (2, 5), (5, 8), (8, 11),
        (0, 3), (3, 6), (6, 9), (9, 14), (14, 17), (17, 19), (19, 21),
        (21, 23), (9, 13), (13, 16), (16, 18), (18, 20), (20, 22), (9, 12), (12, 15),
    ),
    flip_pairs=(
        (1, 2), (4, 5), (7, 8), (10, 11), (13, 14), (16, 17), (18, 19),
        (20, 21), (22, 23),
    ),
)

MANO_SET = JointSet(
    name="mano",
    joints_name=(
        "Wrist", "Thumb_1", "Thumb_2", "Thumb_3", "Thumb_4", "Index_1",
        "Index_2", "Index_3", "Index_4", "Middle_1", "Middle_2", "Middle_3",
        "Middle_4", "Ring_1", "Ring_2", "Ring_3", "Ring_4", "Pinky_1",
        "Pinky_2", "Pinky_3", "Pinky_4",
    ),
    skeleton=(
        (0, 1), (0, 5), (0, 9), (0, 13), (0, 17), (1, 2), (2, 3), (3, 4),
        (5, 6), (6, 7), (7, 8), (9, 10), (10, 11), (11, 12), (13, 14),
        (14, 15), (15, 16), (17, 18), (18, 19), (19, 20),
    ),
    # horizontal finger connections (FreiHAND/dataset.py:40)
    extra_edges=(
        (1, 5), (5, 9), (9, 13), (13, 17), (2, 6), (6, 10), (10, 14),
        (14, 18), (3, 7), (7, 11), (11, 15), (15, 19), (4, 8), (8, 12),
        (12, 16), (16, 20),
    ),
    root_joint="Wrist",
)

_SETS = {s.name: s for s in (HUMAN36, COCO, SMPL_SET, MANO_SET)}
# H36M evaluation joint subset (Human36M/dataset.py:62)
HUMAN36_EVAL_JOINTS = (1, 2, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15, 16)


def get_joint_set(name: str) -> JointSet:
    return _SETS[name]
