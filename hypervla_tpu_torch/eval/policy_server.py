"""Policy server: the action service for simulator clients (counterpart of
hypervla_tpu/eval/policy_server.py).

The simulators run on another machine than the policy, so evaluation
splits across a network boundary: the GPU host runs this server
(hypernetwork generation on reset, the base net per step), and the sim
machine runs `PolicyClient` inside its evaluate loop. The wire format is the
JAX package's, byte for byte: length-prefixed (8-byte little-endian)
pickles over TCP of dicts whose arrays are numpy, never torch tensors, so a
client of either package drives a server of either. Unpickling runs code:
serve only trusted clients on a trusted network.

Server:  python -m hypervla_tpu_torch.eval.policy_server --checkpoint <dir> --port 8777
Client:  PolicyClient("gpu-host", 8777).reset("pick the mug"); .step(image)
"""
import argparse
import pickle
import socket
import struct
import threading


def _send_msg(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv_msg(sock: socket.socket):
    header = _recv_exact(sock, 8)
    if header is None:
        return None
    (length,) = struct.unpack("<Q", header)
    payload = _recv_exact(sock, length)
    if payload is None:
        return None
    return pickle.loads(payload)


def _recv_exact(sock: socket.socket, n: int):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class PolicyServer:
    def __init__(self, wrapper, text_encode_fn, host="0.0.0.0", port=8777):
        """wrapper: an InferenceWrapper; text_encode_fn(str) -> instruction
        dict with input_ids/attention_mask/token_embedding."""
        self.wrapper = wrapper
        self.text_encode_fn = text_encode_fn
        self.host = host
        self.port = port
        self._lock = threading.Lock()

    def serve_forever(self):
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as server:
            server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            server.bind((self.host, self.port))
            server.listen(4)
            print(f"policy server listening on {self.host}:{self.port}")
            while True:
                conn, addr = server.accept()
                threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True).start()

    def _handle(self, conn: socket.socket):
        with conn:
            while True:
                msg = _recv_msg(conn)
                if msg is None:
                    return
                try:
                    with self._lock:
                        reply = self._dispatch(msg)
                except Exception as e:  # report errors to the client
                    reply = {"error": repr(e)}
                _send_msg(conn, reply)

    def _dispatch(self, msg):
        cmd = msg["cmd"]
        if cmd == "ping":
            return {"ok": True}
        if cmd == "reset":
            instruction_dict = self.text_encode_fn(msg["task_description"])
            self.wrapper.reset(
                msg["task_description"],
                instruction_dict,
                initial_state=msg.get("initial_state"),
            )
            return {"ok": True}
        if cmd == "step":
            raw_action, action, image, _, model_time = self.wrapper.step(
                msg["image"])
            return {
                "raw_action": raw_action,
                "action": action,
                "model_time": model_time,
            }
        raise ValueError(f"unknown command {cmd}")


class PolicyClient:
    def __init__(self, host: str, port: int = 8777):
        self.sock = socket.create_connection((host, port))

    def _call(self, msg):
        _send_msg(self.sock, msg)
        reply = _recv_msg(self.sock)
        if reply is None:
            raise ConnectionError("policy server closed the connection")
        if "error" in reply:
            raise RuntimeError(f"policy server error: {reply['error']}")
        return reply

    def ping(self):
        return self._call({"cmd": "ping"})

    def reset(self, task_description: str, initial_state=None):
        return self._call({
            "cmd": "reset",
            "task_description": task_description,
            "initial_state": initial_state,
        })

    def step(self, image):
        return self._call({"cmd": "step", "image": image})

    def close(self):
        self.sock.close()


def main():
    # the client side of this module runs without torch
    from hypervla_tpu_torch.eval.model_loading import (
        build_text_encoder,
        load_hypervla_policy,
    )
    from hypervla_tpu_torch.ops.serving import TRUNK_IMPLS

    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True,
                        help="a checkpoint in the port's format (tools/"
                             "convert_checkpoint_to_torch.py converts a JAX "
                             "one)")
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--port", type=int, default=8777)
    parser.add_argument("--policy_setup", default="google_robot")
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--action_ensemble", action="store_true")
    parser.add_argument("--crop", action="store_true")
    parser.add_argument("--fused_serving", action="store_true",
                        help="serve each step as one call of the fused "
                             "serving step (ops/serving.py) instead of the "
                             "host path")
    parser.add_argument("--trunk_impl", default=None,
                        choices=TRUNK_IMPLS,
                        help="the DINOv2 trunk: the stacked trunk kernel "
                             "(the default for a DINOv2 model), its plain "
                             "version, or the layer loop; a model with a "
                             "generated conv stem takes none")
    parser.add_argument("--cpu", action="store_true",
                        help="serve on the CPU instead of the CUDA card")
    args = parser.parse_args()

    wrapper = load_hypervla_policy(
        args.checkpoint,
        step=args.step,
        policy_setup=args.policy_setup,
        image_size=args.image_size,
        action_ensemble=args.action_ensemble,
        crop=args.crop,
        device="cpu" if args.cpu else None,
        fused_serving=args.fused_serving,
        trunk_impl=args.trunk_impl,
    )
    text_encode_fn = build_text_encoder(wrapper.model)
    PolicyServer(wrapper, text_encode_fn, port=args.port).serve_forever()


if __name__ == "__main__":
    main()
