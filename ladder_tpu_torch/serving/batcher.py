"""Request micro-batching frontend for the inference engine.

Concurrent clients (e.g. the threaded HTTP server's handler threads) each
carry one small request; dispatching them one by one pays one device call
per request. The Batcher coalesces: requests for the same path (and row
shape and dtype) that arrive within a short linger window are concatenated
into one batch, run once through the engine's bucketed paths, and the
result rows are scattered back to their callers. The worker thread also
serialises engine access, so the engine sees single-threaded use however
many HTTP threads are in flight.

Duck-type compatible with InferenceEngine for the batched paths and
delegates everything else (generate, serve_batch, latency_ema, ...) to the
wrapped engine, so ``make_handler(Batcher(engine))`` drops in. The port's
copy of ``ladder_tpu/serving/batcher.py``.

Spans (utils/profiling.py, recorded while a profiler runs): each request
gets an id at submit, and ``serve.queue`` runs from its submit until the
worker takes it into a batch (request and batch ids). The worker records
``serve.wait`` (the queue empty), ``serve.linger``, ``serve.gather``,
``serve.batch`` (batch id, rows, requests: the rows joined and the
engine call) and ``serve.scatter``.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future

import numpy as np

from ladder_tpu_torch.utils.profiling import record, span, stamp

BATCHED_PATHS = ("encode", "decode", "reconstruct", "represent",
                 "decode_representation")


class Batcher:
    def __init__(self, engine, max_wait_ms=2.0, max_rows=None):
        self._engine = engine
        self._max_rows = int(max_rows or engine.serve_batch)
        self._wait = float(max_wait_ms) / 1e3
        self._cond = threading.Condition()
        # (path, (row_shape, dtype), array, future, request id, stamp)
        self._queue = []
        self._closed = False
        self._request_ids = itertools.count()
        self._batch_ids = itertools.count()
        self.stats = {"requests": 0, "batches": 0, "rows": 0,
                      "coalesced": 0}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="serving-batcher")
        self._worker.start()

    # ---- client side --------------------------------------------------
    def submit(self, path, x):
        """Queue one request; returns a concurrent.futures.Future."""
        if path not in BATCHED_PATHS:
            raise ValueError(f"unbatchable path {path!r}")
        x = np.asarray(x)
        if x.ndim == 0 or x.shape[0] == 0:
            raise ValueError("empty batch (0 rows)")
        fut = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            # dtype is part of the key: the engine scales uint8 images by
            # 1/255, so uint8 and float rows must not share a batch
            self._queue.append((path, (x.shape[1:], x.dtype), x, fut,
                                next(self._request_ids), stamp()))
            self.stats["requests"] += 1
            self._cond.notify()
        return fut

    # engine-compatible blocking surface (errors re-raise in the caller)
    def encode(self, x):
        return self.submit("encode", x).result()

    def decode(self, z):
        return self.submit("decode", z).result()

    def reconstruct(self, x):
        return self.submit("reconstruct", x).result()

    def represent(self, x):
        return self.submit("represent", x).result()

    def decode_representation(self, t):
        return self.submit("decode_representation", t).result()

    def __getattr__(self, name):
        # only reached for names not defined above
        return getattr(self._engine, name)

    def close(self, timeout=5.0):
        """Stop taking requests; the worker finishes every queued one."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._worker.join(timeout=timeout)

    # ---- worker -------------------------------------------------------
    def _run(self):
        while True:
            with self._cond:
                if not self._queue and not self._closed:
                    with span("serve.wait"):
                        while not self._queue and not self._closed:
                            self._cond.wait()
                if not self._queue and self._closed:
                    return
                lead = self._queue[0]
            # linger so concurrent peers can join this batch
            if self._wait > 0:
                with span("serve.linger"):
                    time.sleep(self._wait)
            with span("serve.gather"):
                with self._cond:
                    take, rest, rows = [], [], 0
                    for item in self._queue:
                        same = (item[0] == lead[0] and item[1] == lead[1])
                        # the lead is always taken, even when it alone
                        # exceeds max_rows (the engine chunks oversized
                        # batches)
                        if same and (not take
                                     or rows + item[2].shape[0]
                                     <= self._max_rows):
                            take.append(item)
                            rows += item[2].shape[0]
                        else:
                            rest.append(item)
                    self._queue = rest
                batch = next(self._batch_ids)
                for item in take:
                    record("serve.queue", item[5], request=item[4],
                           batch=batch)
            try:
                with span("serve.batch", batch=batch, rows=rows,
                          requests=len(take)):
                    xs = (take[0][2] if len(take) == 1 else
                          np.concatenate([i[2] for i in take], axis=0))
                    out = getattr(self._engine, take[0][0])(xs)
                with span("serve.scatter"):
                    ofs = 0
                    for _, _, x, fut, _, _ in take:
                        n = x.shape[0]
                        if isinstance(out, tuple):
                            fut.set_result(tuple(
                                np.asarray(o)[ofs:ofs + n] for o in out))
                        else:
                            fut.set_result(np.asarray(out)[ofs:ofs + n])
                        ofs += n
                self.stats["batches"] += 1
                self.stats["rows"] += rows
                self.stats["coalesced"] += max(0, len(take) - 1)
            except Exception as e:  # noqa: BLE001 — fault isolation: the
                # failing coalesced batch reports to exactly its callers
                for item in take:
                    item[3].set_exception(e)
