"""The count functions against counts made by hand at small shapes, so
that a share can pass 100% only through a wrong time."""
import pytest

from perfbench.harness import counts


def test_matmul_and_attention():
    assert counts.mm(2, 3, 4) == 48
    # Q K^T: 5 x 5 x 4 MACs, P V the same, x 2 ops, x 3 heads x 2 batch
    assert counts.attention(2, 5, 3, 4) == 2 * (2 * 5 * 5 * 4) * 3 * 2


def test_attention_kernel_bytes():
    ops, nbytes = counts.attention_kernel(2, 5, 3, 4)
    assert ops == 2 * 2 * 5 * 5 * 4 * 2 * 3
    assert nbytes == 4 * (2 * 5 * 3 * 4) * 2  # Q, K, V read, O written
    ops_b, bytes_b = counts.attention_kernel(2, 5, 3, 4, backward=True)
    assert ops_b == 2 * ops
    assert bytes_b == 8 * (2 * 5 * 3 * 4) * 2


def test_dino_layer_gemms_by_hand():
    dino = {"hidden_size": 4, "mlp_ratio": 2}
    # rows 3: QKV 3x12x4, out 3x4x4, fc1 3x8x4, fc2 3x4x8, 2 ops a MAC
    want = 2 * (3 * 12 * 4 + 3 * 4 * 4 + 3 * 8 * 4 + 3 * 4 * 8)
    assert counts.dino_layer_gemms(dino, 3) == want
    ops, nbytes = counts.dino_layer_gemm_kernel(dino, 3)
    assert ops == want
    # each GEMM: activations (3 x k), weights (k x n), output (3 x n), bf16
    want_bytes = 2 * ((12 + 48 + 36) + (12 + 16 + 12) + (12 + 32 + 24)
                      + (24 + 32 + 12))
    assert nbytes == want_bytes


def test_t5_forward_by_hand():
    t5 = {"d_model": 4, "num_heads": 2, "d_kv": 2, "d_ff": 6,
          "num_layers": 1}
    seq = 3
    # q, k, v (3x4 by 4x4), o, wi (4->6), wo (6->4), QK^T and PV per head
    want = 2 * (3 * 3 * 4 * 4 + 3 * 4 * 4 + 3 * 6 * 4 + 3 * 4 * 6
                + 2 * (3 * 3 * 2 * 2))
    assert counts.t5_forward(t5, 1, seq) == want


def test_least_seconds():
    assert counts.least_seconds({"bfloat16": 989e12}) == pytest.approx(1.0)
    assert counts.least_seconds({"float32": 67e12}) == pytest.approx(1.0)
    assert counts.least_seconds({"bfloat16": 0.0}, 3.35e12) == \
        pytest.approx(1.0)


def test_train_step_backward_is_twice_forward_where_inputs_need_it():
    from perfbench.reference.hypervla import base_net_shapes
    from perfbench.tests.tiny import tiny_smallstem

    cfg = tiny_smallstem()
    blocks = base_net_shapes(cfg)
    step = counts.train_step(cfg, blocks, 2, 8)
    vk = cfg["config"]["base_net_kwargs"]["vit_kwargs"]
    stem, first, tokens = counts.smallstem_forward(vk, 2)
    inputs, rest = counts.hypernet_forward(cfg, blocks, 2, 8)
    policy = counts.transformer_forward(2, tokens + 1, vk["hidden_dim"],
                                        vk["num_layers"], vk["mlp_dim"],
                                        vk["num_heads"])
    policy += 2 * counts.mm(1, 4 * 7, vk["hidden_dim"])
    want = (counts.t5_forward(cfg["t5"], 2, 8) + 2 * inputs + 3 * rest
            + 3 * stem - first + 3 * policy)
    assert step["float32"] == want and step["bfloat16"] == 0
