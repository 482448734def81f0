"""Defaults the port keeps from the JAX package: ``DataConfig`` and the
config constants field for field, and the serving entry points' fused
mode, which is 'off' (the JAX package's unfused forward) unless a caller
asks for 'auto' or 'on'."""

import dataclasses
import inspect

import pytest

import irp_tpu.config as jax_config
import irp_tpu.infer as jax_infer
from irp_tpu_torch import config, infer
from irp_tpu_torch.cli import predict_cli, serve_cli


def test_data_config_equals_the_jax_one_field_for_field():
    got = dataclasses.fields(config.DataConfig)
    want = dataclasses.fields(jax_config.DataConfig)
    assert [f.name for f in got] == [f.name for f in want]
    assert dataclasses.asdict(config.DataConfig()) == dataclasses.asdict(
        jax_config.DataConfig())
    assert (config.IMAGE_SIZE, config.EVAL_RESIZE) == (
        jax_config.IMAGE_SIZE, jax_config.EVAL_RESIZE) == (224, 256)
    cfg = config.DataConfig(train_shards=("a.tar",), placement="stream")
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.cache_dir = "x"


@pytest.mark.parametrize("fn", [infer.make_predictor, infer.load_predictor])
def test_serving_defaults_are_the_unfused_forward(fn):
    default = inspect.signature(fn).parameters["fused_frozen_blocks"].default
    assert default == "off"
    # the JAX package infers its serving config with the config's default
    assert jax_config.ModelConfig().fused_frozen_blocks == "off"
    assert "fused_frozen_blocks" not in inspect.signature(
        jax_infer.load_predictor).parameters


def test_the_clis_default_to_off_and_keep_auto_and_on(monkeypatch):
    args = serve_cli.build_parser().parse_args(["--weights", "w.npz"])
    assert args.fused_frozen_blocks == "off"
    args = serve_cli.build_parser().parse_args(
        ["--weights", "w.npz", "--fused-frozen-blocks", "auto"])
    assert args.fused_frozen_blocks == "auto"
    # predict_cli hands its flag to load_predictor: 'off' unless asked
    seen = []

    def fake_load(path, **kw):
        seen.append(kw["fused_frozen_blocks"])
        raise ValueError("stop here")

    monkeypatch.setattr(infer, "load_predictor", fake_load)
    for extra, want in (([], "off"), (["--fused-frozen-blocks", "on"], "on"),
                        (["--fused-frozen-blocks", "auto"], "auto")):
        assert predict_cli.main(["--weights", "w.npz", "--images", "x",
                                 "--cpu", *extra]) == 2
        assert seen[-1] == want
