"""Serving CLI for trained LaDDer models on PyTorch (CUDA by default).

    # sample 64 images from the trained prior into gen.npz
    python -m ladder_tpu_torch.serve --config demo/celeba_config.json \\
        --generate 64 --out gen.npz

    # reconstruct an .npz/.npy of NHWC images (key 'x' or the first array)
    python -m ladder_tpu_torch.serve --config ... --reconstruct in.npz \\
        --out recon.npz

    # write every served path as a torch.export program, <dir>/<name>.pt2
    # (serving/export.py)
    python -m ladder_tpu_torch.serve --config ... --export exported/

    # HTTP endpoint (stdlib, npy request/response bodies)
    python -m ladder_tpu_torch.serve --config ... --http 8787
    #   POST /encode /decode /reconstruct /represent with an .npy body;
    #   GET  /generate?n=16&seed=0 ; GET /healthz

``--device`` defaults to cuda and the CLI fails when there is no CUDA
device; pass ``--device cpu`` to run on the CPU. ``--mesh N`` serves on
cuda:0..N-1, a replica of the model on each and every batch split across
them (serving/engine.py); it raises when fewer devices are available. The
HTTP server micro-batches concurrent requests (``--no-batching`` turns it
off) and drains on SIGTERM/SIGINT: in-flight requests finish and queued
batches run before the process exits.
"""

from __future__ import annotations

import argparse
import io
import json
import sys

import numpy as np


def _load_array(path):
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z["x"] if "x" in z else z[z.files[0]]
    return np.load(path)


def make_handler(engine):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _send_npy(self, arr, code=200):
            buf = io.BytesIO()
            np.save(buf, np.asarray(arr))
            body = buf.getvalue()
            self.send_response(code)
            self.send_header("Content-Type", "application/x-npy")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                info = {"ok": True,
                        "device": str(engine.device),
                        "serve_batch": engine.serve_batch,
                        "buckets": engine.buckets,
                        "latency_ema": engine.latency_ema}
                stats = getattr(engine, "stats", None)
                if stats is not None:  # micro-batching frontend active
                    info["batching"] = dict(stats)
                return self._send_json(info)
            if self.path.startswith("/generate"):
                from urllib.parse import parse_qs, urlparse
                try:
                    q = parse_qs(urlparse(self.path).query)
                    n = int(q.get("n", ["16"])[0])
                    seed = int(q.get("seed", ["0"])[0])
                    if not 0 <= n <= 4096:
                        raise ValueError(
                            f"n must be in [0, 4096], got {n}")
                    return self._send_npy(engine.generate(n, seed=seed))
                except ValueError as e:
                    return self._send_json({"error": str(e)}, 400)
            self._send_json({"error": "unknown path"}, 404)

        def do_POST(self):
            route = self.path.rstrip("/")
            try:
                length = int(self.headers.get("Content-Length", "0"))
                x = np.load(io.BytesIO(self.rfile.read(length)))
                if not isinstance(x, np.ndarray):  # e.g. an .npz archive
                    raise ValueError(
                        "request body must be a single .npy array")
                if x.ndim == 0 or x.shape[0] == 0:
                    raise ValueError("empty batch (0 rows)")
                if route == "/encode":
                    mean, std = engine.encode(x)
                    return self._send_npy(np.stack([mean, std]))
                if route == "/decode":
                    return self._send_npy(engine.decode(x))
                if route == "/reconstruct":
                    return self._send_npy(engine.reconstruct(x))
                if route == "/represent":
                    mean, std = engine.represent(x)
                    return self._send_npy(np.stack([mean, std]))
            except (ValueError, TypeError, KeyError, OSError,
                    EOFError) as e:
                # bad input answers a clean 400, not a dead socket
                return self._send_json({"error": str(e)}, 400)
            except Exception as e:  # noqa: BLE001 — anything else is a
                # server-side fault: 500, so monitoring blames the server
                return self._send_json({"error": str(e)}, 500)
            self._send_json({"error": "unknown path"}, 404)

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def make_http_server(front, port):
    """A ThreadingHTTPServer on 127.0.0.1 whose close is a graceful drain:
    server_close() joins in-flight handler threads (daemon_threads off)."""
    from http.server import ThreadingHTTPServer

    class GracefulHTTPServer(ThreadingHTTPServer):
        daemon_threads = False   # server_close() joins in-flight handlers
        block_on_close = True

    return GracefulHTTPServer(("127.0.0.1", port), make_handler(front))


def serve_http(engine, front, server, quiet=False):
    """Serve until SIGTERM/SIGINT (or server.shutdown()), then drain:
    in-flight handlers finish, queued micro-batches run, and only then does
    the call return."""
    import signal
    import threading

    def _shutdown(signum, frame):
        # shutdown() blocks until serve_forever exits, so it must not run
        # on the thread that is serve_forever
        threading.Thread(target=server.shutdown, daemon=True).start()

    old = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old[sig] = signal.signal(sig, _shutdown)
        except ValueError:  # not the main thread: callers use shutdown()
            pass
    try:
        server.serve_forever()
    finally:
        server.server_close()                     # joins handler threads
        if front is not engine and hasattr(front, "close"):
            front.close()                         # drains queued batches
        for sig, h in old.items():
            signal.signal(sig, h)
        if not quiet:
            print("drained: in-flight requests completed; server closed")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; no silent fallback")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--gm-info", default=None)
    ap.add_argument("--serve-batch", type=int, default=64)
    ap.add_argument("--dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--mesh", type=int, default=0,
                    help="serve on N devices (cuda:0..N-1), a replica on "
                         "each, every batch split across them")
    ap.add_argument("--allow-uninitialized", action="store_true",
                    help="serve random-init weights when checkpoints are "
                         "missing (smoke tests only)")
    ap.add_argument("--bn-stats", default=None,
                    help="bn_stats.npz: freeze the CelebA encoder's "
                         "BatchNorm to population statistics")
    ap.add_argument("--generate", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reconstruct", default=None)
    ap.add_argument("--http", type=int, default=0)
    ap.add_argument("--no-batching", action="store_true",
                    help="disable HTTP request micro-batching")
    ap.add_argument("--batch-wait-ms", type=float, default=2.0,
                    help="micro-batching linger window")
    ap.add_argument("--export", default=None,
                    help="write the paths as torch.export programs here")
    ap.add_argument("--out", default="serving_out.npz")
    args = ap.parse_args(argv)

    from ladder_tpu_torch.serving import InferenceEngine
    from ladder_tpu_torch.utils.config import process_config

    cfg = process_config(args.config)
    engine = InferenceEngine(
        cfg, checkpoint_dir=args.checkpoint_dir, gm_info_path=args.gm_info,
        serve_batch=args.serve_batch, dtype=args.dtype, mesh_devices=args.mesh,
        allow_uninitialized=args.allow_uninitialized,
        bn_stats_path=args.bn_stats, device=args.device)

    if args.export:
        from ladder_tpu_torch.serving.export import export_inference
        for name, path in export_inference(engine, args.export).items():
            print(f"exported {name} -> {path}")
        return 0

    if args.generate:
        imgs = engine.generate(args.generate, seed=args.seed)
        np.savez(args.out, x=imgs, sampled_images=imgs)
        print(f"wrote {imgs.shape} generated images -> {args.out}")
        return 0

    if args.reconstruct:
        recon = engine.reconstruct(_load_array(args.reconstruct))
        np.savez(args.out, x=recon)
        print(f"wrote {recon.shape} reconstructions -> {args.out}")
        return 0

    if args.http:
        secs = engine.warmup()
        front = engine
        if not args.no_batching:
            from ladder_tpu_torch.serving.batcher import Batcher
            front = Batcher(engine, max_wait_ms=args.batch_wait_ms)
        server = make_http_server(front, args.http)
        print(f"warmup {secs:.1f}s; serving on :{args.http} on "
              f"{engine.device} (micro-batching "
              f"{'off' if args.no_batching else 'on'})", flush=True)
        return serve_http(engine, front, server)

    print("nothing to do: pass --generate/--reconstruct/--export/--http")
    return 1


if __name__ == "__main__":
    sys.exit(main())
