"""The port's build_flagship against the JAX package's: for the same
arguments both give the same config (the models' own construction is held
elsewhere), so that `build_flagship()` has one trunk type in each package
(float32: encoder_dtype None keeps the config's own). The port's configs
leave out two keys of the JAX reference that nothing of the port reads
(configs.py::pretrain_config): the hypernetwork's `encoder_type` and the
Octo `model` block. They are left out of the comparison by name."""
import pytest

import hypervla_tpu.flagship as jflagship
import hypervla_tpu_torch.flagship as flagship
from hypervla_tpu.models.base_vit import ViT as jViT
from hypervla_tpu_torch.models.base_vit import ViT
from test_torch_harness import torch_threads  # noqa: F401

#: the JAX config's keys that the port's configs leave out
NOT_PORTED = {("hypernet_kwargs", "encoder_type"), ("model",)}


def _config_of(module, monkeypatch, **kw):
    """The config that `module.build_flagship(tiny=True, **kw)` hands to
    HyperVLA.from_config (which is not run)."""
    seen = {}

    def capture(config, *args, **kwargs):
        seen["config"] = config
        return None

    monkeypatch.setattr(module.HyperVLA, "from_config", capture)
    module.build_flagship(tiny=True, **kw)
    return seen["config"]


def _leaves(tree, path=()):
    if isinstance(tree, dict) and tree:
        out = {}
        for key, value in tree.items():
            out.update(_leaves(value, path + (key,)))
        return out
    return {path: tree}


@pytest.mark.parametrize("kw", [
    {},
    {"serving": True},
    {"training": True},
    {"vit_overrides": {"use_flash_attention": True,
                       "flash_attention_trainable": True}},
    {"encoder_dtype": "bfloat16", "serving": True, "training": True,
     "vit_overrides": {"sow_dino_attention": True}},
], ids=["default", "serving", "training", "vit_overrides", "combined"])
def test_the_configs_are_the_jax_builders(kw, monkeypatch):
    ref = _leaves(_config_of(jflagship, monkeypatch, **kw))
    got = _leaves(_config_of(flagship, monkeypatch, **kw))
    left_out = {p for p in ref if p not in got}
    assert {p[:len(n)] for p in left_out for n in NOT_PORTED
            if p[:len(n)] == n} == NOT_PORTED
    assert all(any(p[:len(n)] == n for n in NOT_PORTED) for p in left_out)
    assert got == {p: v for p, v in ref.items() if p not in left_out}
    if not kw:
        # named nowhere: the ViT's own default, float32, in both packages
        assert ("base_net_kwargs", "vit_kwargs", "encoder_dtype") not in got
        vk = _config_of(flagship, monkeypatch)["base_net_kwargs"][
            "vit_kwargs"]
        assert ViT(vk, 1).encoder_dtype == "float32"
        assert jViT.__dataclass_fields__["encoder_dtype"].default == \
            "float32"
