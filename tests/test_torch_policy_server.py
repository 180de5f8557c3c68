"""The port's policy server (hypervla_tpu_torch/eval/policy_server.py) on
127.0.0.1, on the CPU: its own PolicyClient and the JAX package's drive it
(the wire format is the JAX package's, byte for byte), and the actions equal
those of an in-process InferenceWrapper on the same frames. The model is
the port's tiny fp32 flagship twin, built from a seed: no JAX model is
needed."""
import socket
import sys
import threading

import numpy as np
import pytest

from hypervla_tpu.eval import policy_server as jax_ps
from hypervla_tpu_torch.eval import policy_server as port_ps
from hypervla_tpu_torch.eval.inference import InferenceWrapper
from hypervla_tpu_torch.flagship import build_flagship
from test_torch_serving import STATS
from test_torch_harness import torch_threads  # noqa: F401

TICKS = 3
#: seconds any socket of these tests waits before it fails the test
DEADLINE = 120
WRAPPER = dict(policy_setup="libero", pred_action_horizon=2, image_size=224,
               action_ensemble=True, crop=True)


@pytest.fixture(scope="module")
def tiny():
    model, batch = build_flagship(tiny=True, device="cpu", encoder_dtype=None,
                                  dataset_statistics={"action": STATS})
    instruction = {"language_instruction":
                   batch["task"]["language_instruction"]}
    init = {k: np.asarray(v) for k, v in batch["initial_state"].items()}
    frames = np.random.default_rng(4).integers(0, 256, (TICKS, 256, 256, 3),
                                               dtype=np.uint8)
    return model, instruction, init, frames


def serve_one_connection(server):
    """Binds an ephemeral port on 127.0.0.1 and serves one connection in a
    daemon thread (as tests/test_eval.py serves the JAX server), each wait
    of the listening and the served socket bounded by DEADLINE. Returns
    (port, thread, listening socket)."""
    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.settimeout(DEADLINE)
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)

    def serve():
        conn, _ = sock.accept()
        conn.settimeout(DEADLINE)
        server._handle(conn)

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    return sock.getsockname()[1], thread, sock


@pytest.mark.parametrize("fused_serving", [False, True])
@pytest.mark.parametrize("client", [port_ps, jax_ps],
                         ids=["port_client", "jax_client"])
def test_client_drives_the_port_server(tiny, client, fused_serving):
    model, instruction, init, frames = tiny
    wrapper = InferenceWrapper(model, fused_serving=fused_serving, **WRAPPER)
    local = InferenceWrapper(model, fused_serving=fused_serving, **WRAPPER)
    server = port_ps.PolicyServer(wrapper, lambda _: instruction,
                                  host="127.0.0.1", port=0)
    port, thread, sock = serve_one_connection(server)
    policy = client.PolicyClient("127.0.0.1", port)
    policy.sock.settimeout(DEADLINE)
    try:
        assert policy.ping() == {"ok": True}
        assert policy.reset("pick up the cube", initial_state=init) == {
            "ok": True}
        local.reset("pick up the cube", instruction, init)
        for frame in frames:
            reply = policy.step(frame)
            raw, action, _, _, _ = local.step(frame)
            assert set(reply) == {"raw_action", "action", "model_time"}
            assert type(reply["action"]) is np.ndarray
            np.testing.assert_array_equal(reply["raw_action"], raw)
            np.testing.assert_array_equal(reply["action"], action)
            assert reply["model_time"] >= 0
        with pytest.raises(RuntimeError, match="unknown command jump"):
            policy._call({"cmd": "jump"})
    finally:
        policy.close()
        thread.join(timeout=DEADLINE)
        sock.close()
    assert not thread.is_alive()


def test_unknown_command_comes_back_as_an_error(tiny):
    model, instruction, _, _ = tiny
    server = port_ps.PolicyServer(InferenceWrapper(model, **WRAPPER),
                                  lambda _: instruction)
    port, thread, sock = serve_one_connection(server)
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=DEADLINE) as conn:
        port_ps._send_msg(conn, {"cmd": "jump"})
        assert port_ps._recv_msg(conn) == {
            "error": "ValueError('unknown command jump')"}
    thread.join(timeout=DEADLINE)
    sock.close()
    assert not thread.is_alive()


def test_wire_format_is_the_jax_packages():
    """The same message frames to the same bytes, and each package reads
    the other's."""
    msg = {"cmd": "step", "image": np.arange(12, dtype=np.uint8)}
    sent = {}
    for name, module in (("port", port_ps), ("jax", jax_ps)):
        a, b = socket.socketpair()
        with a, b:
            module._send_msg(a, msg)
            a.shutdown(socket.SHUT_WR)
            sent[name] = b.makefile("rb").read()
    assert sent["port"] == sent["jax"]
    for send, recv in ((port_ps, jax_ps), (jax_ps, port_ps)):
        a, b = socket.socketpair()
        with a, b:
            send._send_msg(a, msg)
            got = recv._recv_msg(b)
        assert got.keys() == msg.keys()
        np.testing.assert_array_equal(got["image"], msg["image"])


@pytest.mark.parametrize("args,fused,trunk_impl", [
    ([], False, "kernel"),
    (["--fused_serving", "--trunk_impl", "layers"], True, "layers")])
def test_main_serves_a_checkpoint_on_the_cpu(tiny, tmp_path, monkeypatch,
                                             args, fused, trunk_impl):
    """`python -m hypervla_tpu_torch.eval.policy_server --checkpoint <dir>
    --cpu [--fused_serving] [--trunk_impl ...]`: the checkpoint's wrapper
    (the host path, or the fused step) on the trunk asked for, and a T5
    text encoder whose instruction length is the checkpoint's, behind the
    server."""
    model, _, init, frames = tiny
    model.save_pretrained(5, str(tmp_path))
    served = {}
    monkeypatch.setattr(port_ps.PolicyServer, "serve_forever",
                        lambda self: served.setdefault("server", self))
    monkeypatch.setattr(sys, "argv", [
        "policy_server", "--checkpoint", str(tmp_path), "--cpu",
        "--policy_setup", "libero", "--action_ensemble", "--port", "0",
        *args])
    port_ps.main()
    server = served["server"]
    assert server.wrapper.model.device.type == "cpu"
    assert server.wrapper.fused_serving == fused
    assert server.wrapper.trunk_impl == trunk_impl
    instruction = server.text_encode_fn("pick up the cube")
    lang = instruction["language_instruction"]
    assert lang["input_ids"].shape == (1, 8)
    assert lang["token_embedding"].shape == (1, 8, 768)
    assert server._dispatch({"cmd": "reset", "task_description": "pick up",
                             "initial_state": init}) == {"ok": True}
    reply = server._dispatch({"cmd": "step", "image": frames[0]})
    assert reply["action"].shape == (7,) and np.isfinite(reply["action"]).all()
