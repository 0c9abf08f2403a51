"""Host-side image loading: decode + fixed-canvas resize + batched prefetch.

The reference's input hot loop is DataLoader worker processes doing PIL
decode and the full torchvision transform stack per image (SURVEY §3.1). In
this build the host only decodes and resizes to a *static* uint8 canvas; the
random augmentation runs on-device. Decode happens in a thread pool (PIL
releases the GIL around JPEG decode), batches are assembled into pinned
numpy arrays, and an optional background thread keeps a queue of ready
batches so host IO overlaps the device step.

A native C++ decoder (``native/``, libjpeg-based) can replace the PIL path
via ``decode_backend='native'`` once built; the interface is identical.

The port's copy of the JAX package's ``data/loader.py``. The ``'auto'``
process view asks ``torch.distributed`` for the rank and the world size
where the JAX package asks JAX for the process index and count, and the
trainer's mesh-derived ``set_process_view`` overrides it. The JAX
package's ``device_put_iterator`` has no counterpart: each rank uploads its
own rows (``Trainer.stage``).
"""
from __future__ import annotations

import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from .folder import ImageFolderIndex


def decode_image(path: str, canvas: tuple[int, int]) -> np.ndarray:
    """Decode one image file to RGB uint8 resized to ``canvas`` (h, w).

    Uses PIL's draft mode for JPEGs (DCT-domain downscale: decodes at the
    smallest scale >= target, typically 2-8x faster than full decode for the
    120k-image corpus).
    """
    from PIL import Image

    with Image.open(path) as im:
        if im.format == "JPEG":
            im.draft("RGB", (canvas[1], canvas[0]))
        im = im.convert("RGB")
        im = im.resize((canvas[1], canvas[0]), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def decode_batch_into(paths: list[str], canvas: tuple[int, int],
                      out: np.ndarray, native=None, nthreads: int = 16,
                      pool: ThreadPoolExecutor | None = None,
                      on_error: str = "raise") -> np.ndarray:
    """Decode ``paths`` into the rows of ``out`` (len(paths), H, W, 3).

    All-JPEG batches go through the native C++ decoder in one call
    (``native/``, ~4x the PIL rate on this host) when it is built; anything
    else (or native failures) falls back to threaded PIL. Shared by the
    training loader and the serving ``full_judge`` path.

    ``on_error``: ``'raise'`` (default — training wants corrupt data LOUD,
    matching the reference loop's behavior) propagates the first decode
    failure; ``'zero'`` zero-fills undecodable slots and returns their
    indices so serving paths can skip corrupt files instead of aborting a
    long judging run. Returns an int index array (always empty for 'raise').
    """
    if on_error not in ("raise", "zero"):
        raise ValueError(f"on_error must be 'raise' or 'zero', got {on_error!r}")
    if native is None:
        from . import native_loader

        native = native_loader if native_loader.available() else False

    def _pil_one(j: int, p: str):
        """Decode one file via PIL; returns j on failure in 'zero' mode."""
        try:
            out[j] = decode_image(p, canvas)
            return None
        except Exception:
            if on_error == "raise":
                raise
            out[j] = 0
            return j

    jpeg_only = all(p.lower().endswith((".jpg", ".jpeg")) for p in paths)
    if native and jpeg_only:
        # one C call decodes the whole batch in a native thread pool
        failed = np.zeros((len(paths),), np.uint8)
        _, failures = native.decode_batch(paths, canvas, out=out,
                                          nthreads=nthreads, failed=failed)
        bad: list[int] = []
        if failures:
            # per-file PIL retry for the flagged slots (libjpeg rejects some
            # files PIL accepts, e.g. a PNG renamed .jpg)
            for j in np.nonzero(failed)[0]:
                r = _pil_one(int(j), paths[j])
                if r is not None:
                    bad.append(r)
        return np.asarray(bad, np.int64)
    run = pool.map if pool is not None else None
    if run is None:
        with ThreadPoolExecutor(max_workers=nthreads) as tmp:
            results = list(tmp.map(_pil_one, range(len(paths)), paths))
    else:
        results = list(run(_pil_one, range(len(paths)), paths))
    return np.asarray([r for r in results if r is not None], np.int64)


class HostImageLoader:
    """Iterable over uint8 batches from an :class:`ImageFolderIndex` subset.

    Static shapes: training batches drop the remainder; eval batches
    pad the tail and carry a validity mask. Yields dicts:
    ``{"image": (B,H,W,3) uint8, "label": (B,) int32, "mask": (B,) bool}``.
    """

    def __init__(
        self,
        index: ImageFolderIndex,
        subset: np.ndarray | None = None,
        batch_size: int = 8,
        canvas: tuple[int, int] = (256, 256),
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        num_threads: int | None = None,
        prefetch_batches: int = 2,
        loop: bool = False,
        decode_backend: str = "auto",
        canvas_cache: bool | str = False,
        process_shard: bool | str | tuple[int, int] = "auto",
        on_error: str = "raise",
    ):
        self.index = index
        self.subset = subset if subset is not None else np.arange(len(index))
        self.batch_size = batch_size
        self.canvas = canvas
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        # Multi-process input sharding: ``batch_size`` is GLOBAL; under N
        # processes each one decodes only batch_size/N images per step
        # (disjoint strided slices of the shared epoch permutation — the
        # DistributedSampler contract), and every process yields the same
        # number of batches per epoch so collectives stay in lockstep.
        # An explicit ``(pid, count)`` tuple overrides the process group's
        # view AND the trainer's later mesh-derived ``set_process_view``.
        self._pid, self._pcount = 0, 1
        self._pinned_view = isinstance(process_shard, tuple)
        if self._pinned_view:
            self._pid, self._pcount = process_shard
        elif process_shard == "auto" or process_shard is True:
            import torch.distributed as dist

            if dist.is_initialized() and dist.get_world_size() > 1:
                self._pid = dist.get_rank()
                self._pcount = dist.get_world_size()
        if batch_size % self._pcount:
            if self._pinned_view:
                raise ValueError(
                    f"global batch {batch_size} not divisible by "
                    f"{self._pcount} processes"
                )
            # the 'auto' guess may be overridden by the trainer's
            # mesh-derived view before iteration (e.g. a pure-EP mesh needs
            # NO split even though the world size doesn't divide the
            # batch): defer the error to iteration time
            self._local_batch = None
        else:
            self._local_batch = batch_size // self._pcount
        # 'raise' (default): corrupt data aborts LOUDLY — a training run must
        # not silently learn from zero images. 'skip': undecodable files are
        # masked out of the batch (serving/statistics consumers that must
        # survive a crawled corpus with a few broken files).
        if on_error not in ("raise", "skip"):
            raise ValueError(
                f"on_error must be 'raise' or 'skip', got {on_error!r}")
        self.on_error = on_error
        self.num_threads = num_threads or min(16, (os.cpu_count() or 8))
        self.prefetch_batches = prefetch_batches
        self.loop = loop
        self._epoch = 0
        self._start_batch = 0
        self._native = None
        if decode_backend in ("auto", "native"):
            from . import native_loader

            if native_loader.available():
                self._native = native_loader
            elif decode_backend == "native":
                raise RuntimeError("native decode backend requested but unavailable")
        self._cache = None
        if canvas_cache:
            from .canvas_cache import CanvasCache

            self._cache = CanvasCache(
                index, self.canvas,
                canvas_cache if isinstance(canvas_cache, str) else None,
            )

    def __len__(self) -> int:
        n = len(self.subset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def steps_per_epoch(self) -> int:
        return len(self)

    def set_process_view(self, pid: int, pcount: int) -> None:
        """Override the multi-process input split.

        The ``process_shard='auto'`` default splits by the world size —
        right only when the batch axis of the mesh aligns with the ranks.
        The trainer calls this with ``parallel.mesh.process_input_view`` of
        its mesh (e.g. a pure-EP mesh replicates the batch across ranks, so
        every rank must load ALL of it: view (0, 1)).
        A loader constructed with an explicit ``(pid, count)`` tuple keeps
        its pinned view (the caller asked for exactly that coverage).
        """
        if self._pinned_view:
            if (pid, pcount) != (self._pid, self._pcount):
                logging.getLogger(__name__).warning(
                    "loader has an explicitly pinned process view %s; "
                    "keeping it over the mesh-derived view %s",
                    (self._pid, self._pcount), (pid, pcount),
                )
            return
        if self.batch_size % pcount:
            raise ValueError(
                f"global batch {self.batch_size} not divisible by "
                f"{pcount} input shards"
            )
        self._pid, self._pcount = pid, pcount
        self._local_batch = self.batch_size // pcount

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Pin the next epoch's shuffle order (DistributedSampler contract)
        and optionally fast-forward ``start_batch`` GLOBAL batches into it.

        The trainer calls this every epoch so the order is a function of
        (seed, epoch) — reproducible across restarts — instead of a
        per-instance counter that resets on resume. ``start_batch`` enables
        exact-step preemption resume: skipped batches are never decoded.
        """
        self._epoch = epoch
        self._start_batch = start_batch

    def _epoch_order(self) -> np.ndarray:
        order = self.subset
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            order = order[rng.permutation(len(order))]
        return order

    def _decode_into(self, paths: list[str], out: np.ndarray,
                     pool: ThreadPoolExecutor) -> np.ndarray:
        """Decode ``paths`` into the rows of ``out`` (len(paths), H, W, 3).
        Returns the row indices that failed to decode (empty in 'raise'
        mode, which propagates instead)."""
        # False (not None) when the native path is unavailable or the
        # backend was explicitly 'pil' — None would make the shared helper
        # re-probe and override the explicit choice
        bad = decode_batch_into(
            paths, self.canvas, out,
            native=self._native if self._native else False,
            nthreads=self.num_threads, pool=pool,
            on_error="zero" if self.on_error == "skip" else "raise")
        for j in bad:
            logging.getLogger(__name__).warning(
                "skipping undecodable image %s", paths[int(j)])
        return bad

    def _make_batch(self, ids: np.ndarray, pool: ThreadPoolExecutor) -> dict:
        n = len(ids)
        b = self._local_batch
        image = np.zeros((b, *self.canvas, 3), np.uint8)
        label = np.zeros((b,), np.int32)
        mask = np.zeros((b,), bool)
        ids = np.asarray(ids)
        if n == 0:
            # a process's share of a ragged global tail can be empty; emit
            # the all-masked batch so step counts match across processes
            return {"image": image, "label": label, "mask": mask}
        if self._cache is not None:
            hit = self._cache.fetch(ids, image[:n])
            miss = np.nonzero(~hit)[0]
            bad = np.asarray([], np.int64)
            if miss.size:
                decoded = np.empty((miss.size, *self.canvas, 3), np.uint8)
                bad = self._decode_into(
                    [self.index.paths[i] for i in ids[miss]], decoded, pool)
                image[miss] = decoded
                # never cache an undecodable slot: done=1 zeros would read as
                # a legitimately black image on the next epoch/process
                good = np.setdiff1d(np.arange(miss.size), bad)
                if good.size:
                    self._cache.store(ids[miss[good]], decoded[good])
            bad = miss[bad] if bad.size else bad
        else:
            bad = self._decode_into([self.index.paths[i] for i in ids],
                                    image[:n], pool)
        label[:n] = self.index.labels[ids]
        mask[:n] = True
        if bad.size:
            mask[bad] = False  # 'skip' mode: corrupt slots leave the batch
        return {"image": image, "label": label, "mask": mask}

    def _iter_epoch(self, pool: ThreadPoolExecutor) -> Iterator[dict]:
        if self._local_batch is None:
            raise ValueError(
                f"global batch {self.batch_size} not divisible by the "
                f"{self._pcount}-process auto input split; set an explicit "
                f"view with set_process_view() (the Trainer does this from "
                f"the mesh) or choose a divisible batch size"
            )
        order = self._epoch_order()
        self._epoch += 1
        skip = self._start_batch
        self._start_batch = 0  # one-shot: later epochs start at batch 0
        # this process's strided slice of the (seed-shared) global order;
        # batch counts below use GLOBAL arithmetic so every process yields
        # the same number of batches regardless of its slice length
        local = order[self._pid::self._pcount] if self._pcount > 1 else order
        b = self._local_batch
        n_full = len(order) // self.batch_size
        for i in range(skip, n_full):
            yield self._make_batch(local[i * b:(i + 1) * b], pool)
        if (not self.drop_last and skip <= n_full
                and len(order) > n_full * self.batch_size):
            yield self._make_batch(local[n_full * b:], pool)

    def __iter__(self) -> Iterator[dict]:
        pool = ThreadPoolExecutor(max_workers=self.num_threads)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = object()
        cancelled = threading.Event()

        def put(item) -> bool:
            """Blocking put that gives up when the consumer is gone (a
            consumer breaking out of the loop — limit_train_batches — must
            not leave this thread wedged on a full queue)."""
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                while not cancelled.is_set():
                    for batch in self._iter_epoch(pool):
                        if not put(batch):
                            return
                    if not self.loop:
                        break
                put(stop)
            except BaseException as e:  # surface decode errors to the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            cancelled.set()
            pool.shutdown(wait=False, cancel_futures=True)

