"""The port's training LayerNorm (hypervla_tpu_torch/ops/layer_norm.py: CPU
tensors take the plain PyTorch versions) against the JAX package's Pallas
`layer_norm_pallas` in interpret mode, forward and gradients, fp32 and
bf16, on the shapes of tests/test_layer_norm_pallas.py (114 rows in blocks
of 32 leave a partial block); the LayerNorm choice of the port's DINOv2
(`fused_ln`) against the JAX model's; the one-pass serving LayerNorm
against the Pallas `layer_norm`.

Tolerances. fp32: 1e-5 on the output, 1e-4 on dx, 1e-4 relative on dscale
and dbias (the Pallas kernel sums bf16 hi/lo halves on the MXU, ~2^-16
relative per term; the port sums in fp32). bf16: one ulp of the tensor's
largest value, 2^-7 * max(scale, 1), on the output and dx (both sides
compute in fp32 and round once; the sums differ in order), and 1e-3
relative on dscale and dbias (fp32 sums of the same bf16 values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.models.encoders import dinov2 as jd
from hypervla_tpu.ops.layer_norm import layer_norm as jax_ln_one_pass
from hypervla_tpu.ops.layer_norm import layer_norm_pallas as jax_ln
from hypervla_tpu_torch import configs
from hypervla_tpu_torch.models.encoders import dinov2 as td
from hypervla_tpu_torch.ops import layer_norm as tln
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _setup(shape):
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 2).astype(np.float32)
    scale = (rs.rand(shape[-1]) + 0.5).astype(np.float32)
    bias = (rs.randn(shape[-1]) * 0.1).astype(np.float32)
    return x, scale, bias


def _err(got, ref):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return np.abs(got - ref).max(), np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 33, 768), (257, 256)])
def test_forward_matches_pallas(dtype, shape):
    jdt, tdt = DTYPES[dtype]
    x, scale, bias = _setup(shape)
    ref = jax_ln(jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
                 1e-6)
    got = tln.layer_norm_pallas(torch.tensor(x).to(tdt), torch.tensor(scale),
                                torch.tensor(bias), 1e-6)
    assert got.dtype == tdt
    err, ref_scale = _err(got, ref)
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * max(ref_scale, 1.0)
    assert err <= tol, (err, ref_scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grads_match_pallas(dtype):
    jdt, tdt = DTYPES[dtype]
    x, scale, bias = _setup((2, 57, 768))
    g = np.random.RandomState(1).randn(2, 57, 768).astype(np.float32)
    _, vjp = jax.vjp(lambda x, s, b: jax_ln(x, s, b, 1e-6, 32),
                     jnp.asarray(x, jdt), jnp.asarray(scale),
                     jnp.asarray(bias))
    ref_dx, ref_ds, ref_db = vjp(jnp.asarray(g, jdt))

    leaves = [torch.tensor(x).to(tdt).requires_grad_(True),
              torch.tensor(scale).requires_grad_(True),
              torch.tensor(bias).requires_grad_(True)]
    tln.layer_norm_pallas(*leaves, 1e-6).backward(torch.tensor(g).to(tdt))
    dx, ds, db = (t.grad for t in leaves)
    assert dx.dtype == tdt and ds.dtype == db.dtype == torch.float32
    err, ref_scale = _err(dx, ref_dx)
    tol = 1e-4 if dtype == "float32" else 2 ** -7 * max(ref_scale, 1.0)
    assert err <= tol, (err, ref_scale)
    for got, ref in ((ds, ref_ds), (db, ref_db)):
        err, ref_scale = _err(got, ref)
        assert err <= (1e-4 if dtype == "float32" else 1e-3) * ref_scale, (
            err, ref_scale)


def test_backward_rows_adds_the_residual_in_bf16():
    """The layer backward's use of the same LayerNorm backward: an fp32
    cotangent, dx rounded to bf16 and added in bf16 to a residual
    gradient; the column sums are those of the call without a residual."""
    rs = np.random.RandomState(2)
    x = torch.tensor(rs.randn(37, 128).astype(np.float32)).bfloat16()
    g = torch.tensor(rs.randn(37, 128).astype(np.float32))
    res = torch.tensor(rs.randn(37, 128).astype(np.float32)).bfloat16()
    scale = torch.tensor((rs.rand(128) + 0.5).astype(np.float32))
    dx, ds, db = tln.layer_norm_bwd_rows(x, g, scale, 1e-6)
    added, ds2, db2 = tln.layer_norm_bwd_rows(x, g, scale, 1e-6, res)
    assert dx.dtype == added.dtype == torch.bfloat16
    assert torch.equal(added, res + dx)
    assert torch.equal(ds, ds2) and torch.equal(db, db2)
    # against autograd of the plain fp32 LayerNorm: one bf16 ulp on dx
    xf = x.float().requires_grad_(True)
    sc = scale.clone().requires_grad_(True)
    bias = torch.zeros(128, requires_grad=True)
    td.layers.layer_norm(xf, sc, bias, 1e-6).backward(g)
    assert (dx.float() - xf.grad).abs().max() <= 2 ** -7 * max(
        float(xf.grad.abs().max()), 1.0)
    torch.testing.assert_close(ds, sc.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(db, bias.grad, rtol=1e-4, atol=1e-4)


def _dino(fused_ln, dtype):
    cfg = jd.dinov2_config("dinov2-test")
    rng = np.random.default_rng(5)
    pixels = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    model = jd.DINOv2Model(config=cfg, dtype=dtype, fused_ln=fused_ln)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"]
    params = jax.tree_util.tree_map(
        lambda v: v + 0.1 * jnp.asarray(rng.standard_normal(v.shape),
                                        v.dtype) if v.ndim == 1 else v,
        params)
    return cfg, model, params, pixels


def test_trunk_route_matches_jax():
    """fused_ln="pallas_train" in the fp32 layer loop (norm1, norm2 and the
    final LayerNorm through the training LayerNorm): the output against the
    JAX model's to 1e-4 of its scale, and the gradient of sum(out * c) per
    leaf at cosine > 0.999 (the JAX package's bound for this route)."""
    cfg, model, params, pixels = _dino("pallas_train", jnp.float32)
    cot = np.random.default_rng(6).standard_normal(
        (2, 257, cfg.hidden_size)).astype(np.float32)

    def loss(p):
        out = model.apply({"params": p}, jnp.asarray(pixels))
        return jnp.sum(out.last_hidden_state * cot), out.last_hidden_state

    (_, ref), ref_grads = jax.value_and_grad(loss, has_aux=True)(params)
    tparams = {k: v.requires_grad_(True)
               for k, v in from_jax_params(params).items()}
    got = td.dinov2_forward(configs.dinov2_config("dinov2-test"), tparams,
                            torch.tensor(pixels), fused_ln="pallas_train")
    err, scale = _err(got.detach(), ref)
    assert err <= 1e-4 * max(scale, 1.0), (err, scale)
    (got * torch.tensor(cot)).sum().backward()
    ref_grads = from_jax_params(ref_grads)
    typical = float(np.median([float(v.norm()) for v in ref_grads.values()]))
    for name, want in ref_grads.items():
        b = want.double().flatten()
        grad = tparams[name].grad
        if float(b.norm()) < 1e-3 * typical:
            # the unused mask token, and the key biases (softmax ignores a
            # uniform key shift): no gradient but rounding noise
            assert grad is None or float(grad.norm()) < 1e-2 * typical, name
            continue
        a = grad.double().flatten()
        assert float(a @ b / (a.norm() * b.norm())) > 0.999, name


def test_layer_norm_choices():
    """False and "dot" are the plain LayerNorm, "pallas_train" the training
    LayerNorm, True the one-pass serving kernel's function (its plain
    version on request)."""
    assert td.layer_norm_fn(False) is td.layer_norm_fn("dot")
    assert td.layer_norm_fn("pallas_train") is tln.layer_norm_pallas
    assert td.layer_norm_fn(True) is tln.layer_norm
    assert td.layer_norm_fn(True, plain=True) is tln.layer_norm_reference
    with pytest.raises(ValueError, match="unknown"):
        td.layer_norm_fn("pallas")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 257, 48), (100, 768)])
def test_one_pass_forward_matches_pallas(dtype, shape):
    """The one-pass serving LayerNorm (two-pass variance) against the JAX
    package's Pallas `layer_norm` in interpret mode, on the shapes of its
    own test (257 and 100 rows leave a partial 128-row block): fp32 1e-5,
    bf16 one ulp of the output's largest value."""
    jdt, tdt = DTYPES[dtype]
    x, scale, bias = _setup(shape)
    x = x + 3.0  # a mean far from 0: where the two variances differ
    ref = jax_ln_one_pass(jnp.asarray(x, jdt), jnp.asarray(scale),
                          jnp.asarray(bias), eps=1e-6)
    tln.reset_launch_counts()
    got = tln.layer_norm(torch.tensor(x).to(tdt), torch.tensor(scale),
                         torch.tensor(bias), 1e-6)
    assert tln.LAUNCHES["layer_norm"] == 0  # CPU: the plain version
    assert got.dtype == tdt
    err, ref_scale = _err(got, ref)
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * max(ref_scale, 1.0)
    assert err <= tol, (err, ref_scale)


def test_one_pass_statistics_from_the_uncast_input():
    """fp32 rows stay fp32 for the statistics and the output; bf16-stored
    scale and bias (the serving step's prepared params) are widened."""
    x, scale, bias = (torch.tensor(a) for a in _setup((7, 64)))
    got = tln.layer_norm(x, scale.bfloat16(), bias.bfloat16())
    assert got.dtype == torch.float32
    ref = tln.layer_norm_reference(x, scale.bfloat16().float(),
                                   bias.bfloat16().float())
    assert torch.equal(got, ref)
    assert not torch.equal(got.bfloat16(),
                           tln.layer_norm(x.bfloat16(), scale, bias))


def test_one_pass_is_forward_only():
    x, scale, bias = (torch.tensor(a) for a in _setup((3, 16)))
    with pytest.raises(RuntimeError, match="forward only"):
        tln.layer_norm(x.requires_grad_(True), scale, bias)
    with torch.no_grad():
        assert tln.layer_norm(x, scale, bias).shape == (3, 16)
