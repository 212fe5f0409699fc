"""PyTorch port: the configuration system against the JAX package's.

Defaults field by field; one JSON file (every section, the TPU one
included) loaded by both packages gives equal trees; a YAML file loads in
the port; unknown sections and keys raise in both.  The one chosen
difference: the port's default data_dir is the relative `data` (the
reference's layout) where the JAX package names its own mount.
"""
import dataclasses
import json

import pytest

from pose2mesh_release_tpu.config import default_config as jax_default_config
from pose2mesh_release_tpu.config import load_config as jax_load_config
from pose2mesh_release_tpu_torch.config import default_config, load_config

SECTIONS = ("DATASET", "MODEL", "TRAIN", "AUG", "TEST", "TPU")


def _tree(cfg):
    out = {s: dataclasses.asdict(getattr(cfg, s)) for s in SECTIONS}
    out.update(output_dir=cfg.output_dir, seed=cfg.seed, data_dir=cfg.data_dir)
    return out


def test_defaults_equal_field_by_field():
    got, want = _tree(default_config()), _tree(jax_default_config())
    assert got.pop("data_dir") == "data"
    want.pop("data_dir")
    assert got == want
    cfg = default_config()
    assert cfg.checkpoint_dir.endswith("checkpoint") and cfg.graph_dir.endswith("graph")


FILE = {
    "DATASET": {"train_list": ["Human36M", "MuCo"], "test_list": ["PW3D"],
                "input_joint_set": "coco", "workers": 4, "use_gt_input": False},
    "MODEL": {"name": "pose2mesh_net", "input_shape": [256, 192], "posenet_hidden": 1024,
              "posenet_pretrained": True, "posenet_path": "./posenet"},
    "TRAIN": {"batch_size": 32, "end_epoch": 7, "lr_step": [3, 5], "optimizer": "adam",
              "scheduler": "plateau", "shuffle": False},
    "AUG": {"flip": True, "rotate_factor": 30.0},
    "TEST": {"batch_size": 16, "deploy": False, "vis": True},
    "TPU": {"compute_dtype": "f32", "steps_per_dispatch": 2, "dense_threshold": 1024},
    "data_dir": "/data", "output_dir": "./out", "seed": 3,
}


def test_one_json_file_gives_equal_trees(tmp_path):
    path = tmp_path / "exp.json"
    path.write_text(json.dumps(FILE))
    got, want = load_config(str(path)), jax_load_config(str(path))
    assert _tree(got) == _tree(want)
    assert got.MODEL.input_shape == (256, 192) and got.TRAIN.lr_step == [3, 5]
    assert got.seed == 3 and got.TPU.steps_per_dispatch == 2
    over = {"TRAIN": {"lr": 0.5}, "TPU": {"graph_axis": 2}}
    assert _tree(load_config(str(path), over)) == _tree(jax_load_config(str(path), over))


def test_yaml_file_loads(tmp_path):
    path = tmp_path / "exp.yml"
    path.write_text("DATASET:\n  train_list: [Human36M]\n  input_joint_set: human36\n"
                    "TRAIN:\n  end_epoch: 15\n  edge_loss_start: 7\n"
                    "MODEL:\n  posenet_pretrained: true\n")
    cfg = load_config(str(path))
    assert cfg.DATASET.train_list == ["Human36M"] and cfg.DATASET.input_joint_set == "human36"
    assert cfg.TRAIN.end_epoch == 15 and cfg.TRAIN.edge_loss_start == 7
    assert cfg.MODEL.posenet_pretrained is True
    assert _tree(cfg) == dict(_tree(jax_load_config(str(path))), data_dir="data")


@pytest.mark.parametrize("bad,match", [
    ({"NOPE": {}}, "unknown config section"),
    ({"TRAIN": {"nope": 1}}, "TRAIN.nope not a known config key"),
    ({"TPU": {"use_cuda": True}}, "TPU.use_cuda not a known config key"),
])
def test_unknown_sections_and_keys_raise(tmp_path, bad, match):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    for load in (load_config, jax_load_config):
        with pytest.raises(ValueError, match=match):
            load(str(path))
    with pytest.raises(ValueError, match="not a known config key"):
        load_config(None, {"MODEL": {"nope": 1}})
