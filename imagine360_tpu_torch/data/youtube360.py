"""YouTube360 dataset tooling (counterpart of
imagine360_tpu/data/youtube360.py; reference dataset/youtube360.csv: clip
rows of youtubeid / videoid / caption / fps / tstart / tend / totalframes).

The reference ships metadata only. This module holds what a training run
needs around it: typed records, and a host-side loader that reads the clips
found on disk, resizes them and prefetches them on a thread.
"""
from __future__ import annotations

import csv
import dataclasses
import os
import queue
import threading
from typing import Iterator, List

import numpy as np

from ..utils.video_io import read_video, resize_frames


@dataclasses.dataclass(frozen=True)
class ClipRecord:
    youtubeid: str
    videoid: str
    caption: str
    fps: float
    tstart: float
    tend: float
    totalframes: int

    @property
    def duration(self) -> float:
        return self.tend - self.tstart


def load_youtube360_csv(path: str) -> List[ClipRecord]:
    records = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            records.append(ClipRecord(
                youtubeid=row.get("youtubeid", ""),
                videoid=row.get("videoid", ""),
                caption=row.get("caption", ""),
                fps=float(row.get("fps", 0) or 0),
                tstart=float(row.get("tstart", 0) or 0),
                tend=float(row.get("tend", 0) or 0),
                totalframes=int(float(row.get("totalframes", 0) or 0)),
            ))
    return records


class YouTube360Dataset:
    """Iterates (frames [F, H, W, 3] uint8, caption) over the clips whose
    videos exist under video_root (files named <videoid>.mp4). Missing or
    unreadable files are skipped: the dataset is download-it-yourself."""

    def __init__(self, csv_path: str, video_root: str, num_frames: int = 32,
                 size_hw=(512, 1024), shuffle: bool = True, seed: int = 0):
        self.records = load_youtube360_csv(csv_path)
        self.video_root = video_root
        self.num_frames = num_frames
        self.size_hw = size_hw
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def _iter_records(self) -> Iterator[ClipRecord]:
        order = np.arange(len(self.records))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in order:
            yield self.records[i]

    def __iter__(self):
        for rec in self._iter_records():
            path = os.path.join(self.video_root, f"{rec.videoid}.mp4")
            if not os.path.exists(path):
                continue
            try:
                frames = read_video(path, num_frames=self.num_frames)
                frames = resize_frames(frames, self.size_hw)
            except Exception:
                continue
            yield frames, rec.caption

    def prefetch(self, buffer: int = 4) -> Iterator:
        """The same items from a background thread, `buffer` ahead, so a
        training step does not wait on video decode."""
        q: queue.Queue = queue.Queue(maxsize=buffer)
        stop = object()

        def worker():
            try:
                for item in self:
                    q.put(item)
            finally:
                q.put(stop)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                return
            yield item
