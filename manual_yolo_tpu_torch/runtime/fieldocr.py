"""Changed-field text OCR over a detection stream (memoised reads).

Counterpart of ``manual_yolo_tpu/runtime/fieldocr.py``, over the port's
``OCREngine.read_fields`` (``runtime/ocr.py``). Every eligible field
(names, stacks, bets, the pot, the game id) carries its text every frame,
but the recognizer reads only the fields whose pixels changed:

  * a per (slot, class id) cache of the last-read crop and its text: the
    table taxonomy has one element per class, so the class id names the
    field;
  * photometric tolerance: a global brightness or channel shift moves every
    pixel of a crop by the same per-channel constant, so the change test is
    on the span of the pixel delta, not its size;
  * a content memo: identical pixels of one class read once, whatever lane
    or frame they came from;
  * all changed fields of a batch go to one ``read_fields`` call, or, with
    ``async_reads``, to a reader thread whose texts land in the caches for
    the next batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from manual_yolo_tpu_torch.game import taxonomy

# max per-channel span of (crop - cached crop) still considered "the same
# content": a pure shift has span 0; clipping at 0/255 widens it by a few
# counts; any text/content repaint produces spans in the hundreds
SHIFT_SPAN = 10
# and the shift itself must be small (two +-6 jitters are at most 12 apart)
SHIFT_ABS = 24


def is_text_field(class_name: str) -> bool:
    """OCR-eligible classes (the reference's cascade fields, minus ranks
    and suits which the classifier path owns — detect.py:231-251)."""
    if class_name in taxonomy.RANK_CLASSES:
        return False
    return class_name.endswith(("_name", "_stack", "_bet")) or class_name in (
        "total_pot", "game_id", "iinput_field", "my_stack", "my_bet",
    )


def same_content(cached: np.ndarray, crop: np.ndarray) -> bool:
    """True when ``crop`` differs from ``cached`` by at most a global
    per-channel photometric shift (plus clipping slack)."""
    if cached.shape != crop.shape:
        return False
    d = crop.astype(np.int16) - cached
    flat = d.reshape(-1, d.shape[-1]) if d.ndim == 3 else d.reshape(-1, 1)
    lo = flat.min(axis=0)
    hi = flat.max(axis=0)
    return bool(
        (hi - lo <= SHIFT_SPAN).all()
        and (np.abs(flat.mean(axis=0)) <= SHIFT_ABS).all()
    )


class FieldOCRMemo:
    """Batched changed-field OCR over per-slot detection results.

    One instance serves a whole :class:`BatchStream`: slot ``i`` is one
    stream lane (one table / one capture source), and the cache key is
    ``(slot, class_id)``. Call :meth:`process` after ``collect_batch``;
    it fills ``det["ocr_text"]`` in place for every eligible field —
    from cache when the pixels only shifted, from the recognizer (one
    batched call for ALL slots' changed fields) otherwise.
    """

    def __init__(self, engine, pad: int = 2, max_read_per_batch: int = 512,
                 async_reads: bool = False):
        self.engine = engine
        self.pad = pad
        self.max_read_per_batch = max_read_per_batch
        self._cache: Dict[Tuple[int, int], Tuple[np.ndarray, str]] = {}
        # content-level memo: (class_id, crop shape, pixel digest) -> text.
        # Identical pixels mean identical text whichever lane or frame they
        # came from, so shared skin elements and lanes of the same source
        # collapse to one read. Exact bytes only; photometric shifts are
        # the per-slot cache's job (the span test above).
        self._content: Dict[Tuple, str] = {}
        self.fields_seen = 0
        self.fields_read = 0
        self.fields_memo = 0
        self.fields_dedup = 0
        self.fields_deferred = 0
        self.errors = 0  # failed async reads (their fields keep older text)
        # async mode: recognizer reads run on a daemon thread and land in
        # the caches when done; the next batch's identical pixels memo-hit
        # with the fresh text, so a field's text lags at most one batch and
        # the caller's loop never waits on the recognizer. The per-frame
        # contract is the synchronous deferral path's (`max_read_per_batch`):
        # a field whose read is in flight carries its previous text (or ""
        # on first sight).
        import queue as queue_mod
        import threading

        self._lock = threading.Lock()
        self._async_q = None
        self._async_thread = None
        self._async_pending = 0  # queued + in-flight read batches
        if async_reads:
            self._async_q = queue_mod.Queue(maxsize=2)

            def _reader():
                while True:
                    item = self._async_q.get()
                    if item is None:
                        return
                    crops, names, metas = item
                    try:
                        texts = self.engine.read_fields(crops, names)
                    except Exception as e:  # degrade, keep the loop alive
                        print(f"async field-OCR error: {e}")
                        with self._lock:
                            self.errors += 1
                            self._async_pending -= 1
                        continue
                    with self._lock:
                        self.fields_read += len(crops)
                        if len(self._content) > 200_000:
                            self._content.clear()
                        for (key, crop_i16, ckey, ui) in metas:
                            text = texts[ui] or ""
                            self._cache[key] = (crop_i16, text)
                            self._content[ckey] = text
                        self._async_pending -= 1

            self._async_thread = threading.Thread(target=_reader, daemon=True)
            self._async_thread.start()

    def process(self, frames: List[np.ndarray],
                results: List[List[dict]]) -> int:
        """Fill ``ocr_text`` on eligible fields; returns #recognizer reads."""
        import hashlib

        from manual_yolo_tpu_torch.runtime.native import crop_u8

        refs: List[Tuple[int, int, Tuple[int, int], np.ndarray, Tuple, int]] = []
        unique: Dict[Tuple, int] = {}
        crops: List[np.ndarray] = []
        names: List[str] = []
        p = self.pad
        for slot, (frame, dets) in enumerate(zip(frames, results)):
            if frame is None:
                continue
            for di, d in enumerate(dets):
                name = d["class_name"]
                if not is_text_field(name):
                    continue
                self.fields_seen += 1
                x1, y1, x2, y2 = d["bbox"]
                crop = crop_u8(frame, y1 - p, x1 - p, y2 + p, x2 + p)
                if crop.size == 0:
                    continue
                key = (slot, d["class_id"])
                hit = self._cache.get(key)
                if hit is not None and same_content(hit[0], crop):
                    d["ocr_text"] = hit[1]
                    self.fields_memo += 1
                    continue
                ckey = (d["class_id"], crop.shape,
                        hashlib.sha1(crop.tobytes()).digest())
                text2 = self._content.get(ckey)
                if text2 is not None:
                    d["ocr_text"] = text2
                    self._cache[key] = (crop.astype(np.int16), text2)
                    self.fields_dedup += 1
                    continue
                ui = unique.get(ckey)
                if ui is None:
                    if len(crops) >= self.max_read_per_batch:
                        # overload guard: better one stale field than an
                        # unbounded recognizer batch; it re-tries next batch
                        self.fields_deferred += 1
                        if hit is not None:
                            d["ocr_text"] = hit[1]
                        continue
                    ui = len(crops)
                    unique[ckey] = ui
                    crops.append(crop)
                    names.append(name)
                else:
                    self.fields_dedup += 1
                refs.append((slot, di, key, crop.astype(np.int16), ckey, ui))
        if crops and self._async_q is not None:
            # async mode: hand the whole read batch to the reader thread;
            # this batch's fresh fields keep their previous text (the
            # per-slot cache fallback below) and the NEXT batch memo-hits
            # with the completed read. A full queue defers like the
            # synchronous overload guard.
            import queue as queue_mod

            metas = [(key, crop_i16, ckey, ui)
                     for (_s, _d, key, crop_i16, ckey, ui) in refs]
            try:
                self._async_q.put_nowait((crops, names, metas))
                with self._lock:
                    self._async_pending += 1
            except queue_mod.Full:
                self.fields_deferred += len(crops)
            for (slot, di, key, _crop_i16, _ckey, _ui) in refs:
                hit = self._cache.get(key)
                if hit is not None and not results[slot][di].get("ocr_text"):
                    results[slot][di]["ocr_text"] = hit[1]
            return 0
        if crops:
            texts = self.engine.read_fields(crops, names)
            self.fields_read += len(crops)
            if len(self._content) > 200_000:  # bound long-run memory
                self._content.clear()
            for (slot, di, key, crop_i16, ckey, ui) in refs:
                text = texts[ui] or ""
                results[slot][di]["ocr_text"] = text
                self._cache[key] = (crop_i16, text)
                self._content[ckey] = text
        return len(crops)

    def flush(self, timeout: float = 30.0) -> None:
        """Block until queued async reads have landed in the caches
        (no-op in synchronous mode; used by tests and orderly shutdown)."""
        if self._async_q is None:
            return
        import time as time_mod

        t0 = time_mod.monotonic()
        while time_mod.monotonic() - t0 <= timeout:
            with self._lock:
                if self._async_pending == 0:
                    return
            time_mod.sleep(0.01)

    def close(self) -> None:
        if self._async_q is not None:
            self._async_q.put(None)
            if self._async_thread is not None:
                self._async_thread.join(timeout=5)

    def stats(self) -> Dict[str, int]:
        return {
            "fields_seen": self.fields_seen,
            "fields_read": self.fields_read,
            "fields_memo": self.fields_memo,
            "fields_dedup": self.fields_dedup,
            "fields_deferred": self.fields_deferred,
        }
