"""Web model daemon: lazy load, idle unload, micro-batched predict on the
GPU, label language remapping (counterpart of the repository's
``web/runtime.py``, which drives the JAX package).

The same ``ModelDaemon``:

- a lazy-loading singleton that builds the port's ``Predictor`` (``init``
  of ``infer/serve.py``) on the first request and unloads after 5 minutes
  idle through a ``threading.Timer``;
- the lock guards the queue and the lifecycle, never the device call, and
  the idle unload stays up while requests are queued;
- cross-request micro-batching: requests enqueue and one worker thread
  coalesces what is queued, up to ``MAX_BATCH_SIZE`` images, into one
  device call, then hands each request its slice;
- ``serve_batch`` chunks by ``MAX_BATCH_SIZE`` and remaps the CN labels to
  JP/EN from the data file ``web/th_name_lang_map.csv`` of the repository.

``TIC_WEB_MODEL_TYPE``, ``TIC_WEB_WEIGHTS`` and ``TIC_WEB_DATA_DIR`` name
the model, its weights and the dataset of its class map, as for the JAX
demo. The device is explicit: :data:`DEVICE` (``cuda``; the app's
``--device`` sets it), and CUDA without a GPU raises at the first request.
"""
from __future__ import annotations

import os
import threading

_PROJECT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the label map is a data file of the repository's web demo
_LANG_MAP_DIR = os.path.join(_PROJECT_ROOT, "web")

_WEIGHTS = os.path.join(_PROJECT_ROOT, "checkpoint/serving/nvit")
_DATA = os.path.join(_PROJECT_ROOT, "data/data_filtered_vit_base")
MODEL_TYPE = os.environ.get("TIC_WEB_MODEL_TYPE", "vit-large")
WEIGHTS_PATH = os.environ.get("TIC_WEB_WEIGHTS", _WEIGHTS)
DATA_DIR = os.environ.get("TIC_WEB_DATA_DIR", _DATA)
DEVICE = "cuda"
INACTIVITY_TIMEOUT = 5 * 60  # seconds
MAX_BATCH_SIZE = 64

ACTUAL_LABEL_LANG = "CN"
DEFAULT_LABEL_LANG = "JP"


class _Request:
    __slots__ = ("images", "event", "results", "error")

    def __init__(self, images):
        self.images = list(images)
        self.event = threading.Event()
        self.results = None
        self.error = None


class ModelDaemon:
    def __init__(self):
        self.predictor = None
        self.timer = None
        self.lock = threading.Lock()
        self._queue: "list[_Request]" = []
        self._have_work = threading.Event()
        self._worker = None

    # -- lifecycle (call under self.lock) ---------------------------------

    def start(self):
        if self.predictor is None:
            print("Starting model daemon...")
            from ..infer.serve import init

            self.predictor = init(modelt=MODEL_TYPE, weights=WEIGHTS_PATH,
                                  data_dir=DATA_DIR, device=DEVICE)
            print("Model daemon started successfully.")
        self._reset_timer()

    def stop(self):
        with self.lock:
            if self._queue:
                # work arrived as the idle timer fired: stay up
                self._reset_timer()
                return
            if self.predictor is not None:
                print("Stopping model daemon due to inactivity...")
                self.predictor = None
            if self.timer:
                self.timer.cancel()
                self.timer = None
        # the worker thread stays parked on its event; an in-flight batch
        # keeps serving from its own predictor reference (stop never yanks
        # the model out from under a running device call)

    def _reset_timer(self):
        if self.timer:
            self.timer.cancel()
        self.timer = threading.Timer(INACTIVITY_TIMEOUT, self.stop)
        self.timer.daemon = True
        self.timer.start()

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._worker_loop,
                                            daemon=True)
            self._worker.start()

    # -- inference ---------------------------------------------------------

    def predict(self, images):
        """images: list of PIL images -> [(class_name, confidence)].

        Enqueues and waits; the worker thread coalesces concurrently queued
        requests into one device batch. The lock guards only queue/lifecycle
        state — never the device call — so requests arriving mid-inference
        queue up instead of blocking on the lock."""
        req = _Request(images)
        with self.lock:
            if self.predictor is None:
                self.start()
            self._reset_timer()
            self._ensure_worker()
            self._queue.append(req)
            self._have_work.set()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.results

    def _worker_loop(self):
        while True:
            self._have_work.wait()
            with self.lock:
                batch: list[_Request] = []
                total = 0
                while self._queue and (
                    not batch
                    or total + len(self._queue[0].images) <= MAX_BATCH_SIZE
                ):
                    batch.append(self._queue.pop(0))
                    total += len(batch[-1].images)
                if not self._queue:
                    self._have_work.clear()
                # this iteration's OWN reference: stop() can null
                # self.predictor mid-inference but never yanks the model out
                # from under this device call. No reference
                # outlives the iteration — keeping one would pin the params
                # (host + device HBM) forever and defeat the idle unload.
                predictor = self.predictor
            if not batch:
                continue
            try:
                if predictor is None:
                    # unreachable by the lock discipline (stop() stays up
                    # while the queue is non-empty); fail the waiters loudly
                    # rather than hanging them if it ever regresses
                    raise RuntimeError("daemon stopped with queued requests")
                flat = [im for r in batch for im in r.images]
                results = predictor.predict_images(flat)
                pos = 0
                for r in batch:
                    r.results = results[pos:pos + len(r.images)]
                    pos += len(r.images)
            except Exception as e:  # deliver the failure to every waiter
                for r in batch:
                    r.error = e
            finally:
                for r in batch:
                    r.event.set()
                # drop the reference before parking on the event again —
                # a live local across the idle wait would pin the unloaded
                # model until the next request
                predictor = None
                del batch


daemon = ModelDaemon()


def is_daemon_running() -> bool:
    return daemon.predictor is not None


def is_daemon_accelerated() -> bool:
    """Whether the loaded predictor runs on a GPU (its device's type)."""
    predictor = daemon.predictor
    return predictor is not None and predictor.device.type == "cuda"


# ---------------------------------------------------------------------------
# label language remapping
# ---------------------------------------------------------------------------

label_lang_map: dict[str, dict[str, str]] = {}


def prepare_label_lang_map(file: str = "th_name_lang_map.csv") -> None:
    global label_lang_map
    if label_lang_map:
        return
    filepath = os.path.join(_LANG_MAP_DIR, file)
    if not os.path.exists(filepath):
        print(f"Warning: Language map file '{file}' not found in '{_LANG_MAP_DIR}'.")
        return
    with open(filepath, encoding="utf-8") as f:
        lines = [l.rstrip("\n") for l in f if l.strip()]
    if not lines:
        return
    header = [h.strip() for h in lines[0].split(",")]
    if ACTUAL_LABEL_LANG not in header:
        raise ValueError(
            f"ACTUAL_LABEL_LANG '{ACTUAL_LABEL_LANG}' not found in header of {file}"
        )
    actual_idx = header.index(ACTUAL_LABEL_LANG)
    label_lang_map = {lang: {} for lang in header}
    for line in lines[1:]:
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != len(header):
            continue
        actual = parts[actual_idx]
        for i, lang in enumerate(header):
            if parts[i]:
                label_lang_map[lang][actual] = parts[i]


def remap_label_lang(label: str, target_lang: str = DEFAULT_LABEL_LANG) -> str:
    if not label_lang_map:
        prepare_label_lang_map()
    return label_lang_map.get(target_lang, {}).get(label, label)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def serve_batch(images: list, target_lang: str = DEFAULT_LABEL_LANG):
    """Chunked batched prediction + language remap. Returns
    (results, started_cold)."""
    started = not is_daemon_running()
    results = []
    for i in range(0, len(images), MAX_BATCH_SIZE):
        results.extend(daemon.predict(images[i:i + MAX_BATCH_SIZE]))
    results = [
        (remap_label_lang(label, target_lang), confidence)
        for label, confidence in results
    ]
    return results, started
