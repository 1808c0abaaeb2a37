"""The port's config loading against the JAX package: ``load_config`` on
each ``configs/*.yaml``, with and without overrides and names presets,
equals JAX's field by field; the YAML reader equals ``yaml.safe_load`` on
those files; the saved ``config.yaml`` reads back to the same dict through
both readers; a JAX-only setting the port does not run is refused."""

import dataclasses
from pathlib import Path

import pytest
import yaml

from s2anet_tpu.utils import config as jax_config
from s2anet_tpu_torch import config, yaml_lite

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.yaml"))
OVERRIDES = [
    None,
    {"model": {"backbone": "resnet18", "num_classes": 4}, "train": {"epochs": 2, "lr0": 0.02}},
    {"data": {"names": "dota-v1.5", "img_size": 512}, "train": {"nominal_batch_size": 64}},
    {"data": {"names": ["x", "y"]}, "eval": {"batch_size": 4}},
    {"model": {"num_classes": 17}},
]


def _plain(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def _assert_same(got, want):
    for section in ("model", "data", "train", "eval"):
        g, w = getattr(got, section), getattr(want, section)
        for f in dataclasses.fields(g):
            assert _plain(getattr(g, f.name)) == _plain(getattr(w, f.name)), (section, f.name)


def test_config_paths_present():
    assert len(CONFIGS) == 4


@pytest.mark.parametrize("path", CONFIGS + [None], ids=lambda p: p.name if p else "defaults")
@pytest.mark.parametrize("over", range(len(OVERRIDES)))
def test_load_config_matches_jax(path, over):
    o = OVERRIDES[over]
    _assert_same(config.load_config(path, o), jax_config.load_config(path, o))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_reader_matches_safe_load(path):
    text = path.read_text()
    assert yaml_lite.load(text) == yaml.safe_load(text)


def test_yaml_reader_scalars_and_flow_maps():
    text = ("a: {b: [1, 2.5, '3', x y], c: {d: ~}}  # comment\n"
            "e:\n  f: 1e-4\n  g: 1.0e-4\n  h: yes\n  i: Off\n  j: .inf\n  k: \"q#r\"\n"
            "  l: 007x\n  m: -0.5\n  n:\n")
    assert yaml_lite.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_saved_config_round_trips(path, tmp_path):
    cfg = config.load_config(path, {"train": {"save_dir": "runs/x'y", "lrf": 1e-5}})
    cfg.save(tmp_path / "config.yaml")
    text = (tmp_path / "config.yaml").read_text()
    want = yaml.safe_load(yaml.safe_dump(cfg.to_dict(), sort_keys=False))
    assert yaml.safe_load(text) == want
    assert yaml_lite.load(text) == want
    _assert_same(config.load_config(tmp_path / "config.yaml"), cfg)


def test_prune_overrides_matches_jax():
    tree = {"model": {"backbone": None, "num_classes": 3}, "data": {"root": None},
            "train": {"plots": False, "seed": 0}}
    assert config.prune_overrides(tree) == jax_config.prune_overrides(tree)


@pytest.mark.parametrize("over", [{"model": {"with_orconv": False}},
                                  {"model": {"bn_stats_images": 2}},
                                  {"eval": {"rect": True}}])
def test_unported_settings_raise(over, tmp_path):
    with pytest.raises(NotImplementedError, match="not ported"):
        config.load_config(None, over)
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(over))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        config.load_config(tmp_path / "c.yaml")
    # implementation switches of the JAX package are ignored
    assert config.load_config(None, {"model": {"deform_impl": "gather"}}) == config.Config()
