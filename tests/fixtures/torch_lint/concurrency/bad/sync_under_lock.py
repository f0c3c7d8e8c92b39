"""BAD: a host sync (``.item()`` on a device tensor, a stream's
``synchronize()``) while holding ``_lock``, the lock every dispatch from the
worker thread and from direct callers also takes: one slow kernel stalls the
whole dispatch path. The port's concurrency model counts torch's host syncs
as blocking calls, so YAMT021 sees them; the JAX package's does not."""

import threading

import torch


class Engine:
    def __init__(self, fn):
        self._fn = fn
        self._lock = threading.Lock()
        self._stream = torch.cuda.Stream()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()
        return self.predict(0)

    def _loop(self):
        try:
            while not self._stop.is_set():
                self.predict(1)
        except Exception:
            self._crashed = True

    def predict(self, key):
        with self._lock:
            y = self._fn(key)
            self._stream.synchronize()
            return y.sum().item()
