"""Asynchronous input pipeline: sampling, decoding and tokenizing in a producer thread,
behind a bounded queue; the port of ``r3m_tpu/data/pipeline.py``.

It replaces the reference's ``torch.utils.data.DataLoader(num_workers=10,
pin_memory=True)`` over an IterableDataset (``r3m/train_representation.py:54-61``): the
host work (manifest sampling, native JPEG decoding, WordPiece tokenizing) runs in one
producer thread feeding a bounded queue, so a warm queue never makes the step wait. The
reference's device share of that pipeline (RandomResizedCrop and normalisation) runs in
the train step on the card (``data/augment.py``).

It yields host numpy batch dicts; the workspace places them on the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from r3m_tpu_torch.data.ego4d import FrameBatcher
from r3m_tpu_torch.text.tokenizer import WordPieceTokenizer


class ProducerQueue:
    """One background producer feeding a bounded queue (the machinery of the host data
    pipeline and of the workspace's device prefetch).

    `source` items are pulled and `transform`ed in the producer thread; an error surfaces
    on the consumer's next pull, `StopIteration` from the source ends iteration cleanly,
    and `close()` joins with a timeout. With `reserve_first=True` the producer waits for
    queue space before transforming, for transforms that hold scarce memory (device
    placement): at most `maxsize` transformed items exist at once.
    """

    def __init__(
        self,
        source,
        maxsize: int = 2,
        transform=None,
        reserve_first: bool = False,
        name: str = "producer",
    ):
        self._source = iter(source)
        self._transform = transform
        self._name = name
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, maxsize))
        # reserve_first bounds TRANSFORMED items with a semaphore so the
        # producer can wait for capacity BEFORE transforming; a consumer
        # release wakes the blocked acquire instantly (the short timeout
        # only bounds shutdown latency, it is not a poll interval)
        self._space = (
            threading.Semaphore(max(1, maxsize)) if reserve_first else None
        )
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            while not self._stop.is_set():
                item = next(self._source)
                if self._space is not None:
                    while not self._stop.is_set():
                        if self._space.acquire(timeout=0.25):
                            break
                    if self._stop.is_set():
                        break
                if self._transform is not None:
                    item = self._transform(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
        except StopIteration:
            pass  # finite source drained — clean exit
        except BaseException as e:  # surfaced on next __next__
            self._err = e

    def __iter__(self):
        return self

    def _release(self, item):
        if self._space is not None:
            self._space.release()
        return item

    def __next__(self):
        while True:
            # drain already-produced items before surfacing a late failure
            try:
                return self._release(self._q.get_nowait())
            except queue.Empty:
                pass
            if self._err is not None:
                raise RuntimeError(f"{self._name} failed") from self._err
            try:
                return self._release(self._q.get(timeout=1.0))
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    # producer exited (cleanly, or close() raced this call)
                    if self._err is not None:
                        continue  # surface the error, not StopIteration
                    raise StopIteration
                continue

    def close(self) -> bool:
        """Stop + join the producer; False if it didn't exit in time."""
        self._stop.set()
        self._thread.join(timeout=30.0)
        return not self._thread.is_alive()


class DataPipeline:
    """Producer-thread pipeline; iterate to get batch dicts.

    Batch dict fields (what `r3m_tpu_torch.training.trainer.make_train_step` takes):
      images    [B, 5, H, W, 3] uint8
      token_ids [B, T] int32, attn_mask [B, T] int32, lang_mask [B] f32 (with a tokenizer)
      captions  list[str] (host only; dropped before the batch goes to the device)
    """

    def __init__(
        self,
        batcher: FrameBatcher,
        tokenizer: Optional[WordPieceTokenizer] = None,
        lang_max_len: int = 32,
        prefetch: int = 2,
    ):
        self.batcher = batcher
        self.tokenizer = tokenizer
        self.lang_max_len = lang_max_len

        def batches():
            while True:
                yield self._make_batch()

        self._pq = ProducerQueue(
            batches(), maxsize=prefetch, name="data pipeline producer"
        )

    def _make_batch(self) -> Dict:
        # batchers return fresh caller-owned arrays — no defensive copy
        clips, captions = self.batcher.next_batch()
        batch: Dict = {"images": clips, "captions": captions}
        if self.tokenizer is not None:
            ids, mask = self.tokenizer.encode_batch(captions, self.lang_max_len)
            batch["token_ids"] = ids
            batch["attn_mask"] = mask
            batch["lang_mask"] = np.asarray(
                [1.0 if c != "" else 0.0 for c in captions], dtype=np.float32
            )
        return batch

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        return next(self._pq)

    def close(self):
        if not self._pq.close():
            # The producer is wedged (e.g. a decode stuck on bad storage): freeing the
            # native batcher state under its running thread would be a use after free,
            # so it is leaked instead.
            print("[pipeline] producer did not exit; leaking batcher state")
            return
        if hasattr(self.batcher, "close"):
            self.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
