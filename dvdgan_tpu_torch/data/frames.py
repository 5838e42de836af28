"""On-disk video dataset: UCF-101-style extracted-frame directories — the
counterpart of `dvdgan_tpu/data/frames.py` (the same listing, window draws,
crop, resize and scaling, so the same seed, epoch and index give the same
clip bytes).

`root/<class_name>/<video_name>/` directories of frame images, `.npy` clip
files (T0, H, W, 3) uint8 or float, or video files where a decoder exists;
a uniformly drawn T-frame window (short clips wrap), center-cropped to
square, nearest-resized to `img_size`, scaled to [-1, 1]; items are
(clip (T, H, W, 3) float32, int label) with class names mapped to labels in
sorted order.

Both decoders are optional and imported at first use: PIL for frame images
and imageio (with ffmpeg or PyAV for containers) for video files. A host
without PIL reads `.npy` clips, and a folder of image files raises there
with a message that says so.
"""

from __future__ import annotations

import functools
import importlib.util
import os
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np

from dvdgan_tpu_torch import native

_IMG_EXT = (".jpg", ".jpeg", ".png", ".bmp")
_VIDEO_EXT = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".gif")
# container formats need a codec backend (ffmpeg or PyAV), not imageio
# alone; GIFs decode through imageio's Pillow plugin
_CONTAINER_EXT = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def _has_codec_backend() -> bool:
    return any(importlib.util.find_spec(m) is not None
               for m in ("imageio_ffmpeg", "av"))


@functools.cache
def _video_reader() -> Optional[Callable[[str], np.ndarray]]:
    """`path -> (T, H, W, 3) uint8` through imageio, or None where imageio
    does not import; looked up once, at the first video file."""
    try:
        import imageio.v3 as iio
    except ImportError:
        return None

    def read(path: str) -> np.ndarray:
        arr = np.asarray(iio.imread(path, plugin=None))
        if arr.ndim == 2:                   # one grayscale frame
            arr = arr[None, ..., None]
        elif arr.ndim == 3:
            if arr.shape[-1] in (2, 3, 4):  # one LA/RGB/RGBA frame
                arr = arr[None]
            else:                           # a grayscale video (T, H, W)
                arr = arr[..., None]
        elif arr.ndim != 4:
            raise ValueError(f"undecodable array rank {arr.ndim} from {path}")
        if arr.shape[-1] == 2:              # LA: drop alpha
            arr = arr[..., :1]
        if arr.shape[-1] == 1:              # L: replicate to RGB
            arr = np.repeat(arr, 3, axis=-1)
        elif arr.shape[-1] == 4:            # RGBA GIFs
            arr = arr[..., :3]
        elif arr.shape[-1] != 3:
            raise ValueError(
                f"unsupported channel count {arr.shape[-1]} in {path}")
        return np.ascontiguousarray(arr.astype(np.uint8))

    return read


def _decodable(path: str) -> bool:
    """True when a video file will decode here: containers need ffmpeg or
    PyAV besides imageio."""
    if _video_reader() is None:
        return False
    if path.lower().endswith(_CONTAINER_EXT):
        return _has_codec_backend()
    return True


def _list_videos(root: str) -> Tuple[List[Tuple[str, int]], List[str]]:
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    items: List[Tuple[str, int]] = []
    skipped_raw = 0
    for li, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for v in sorted(os.listdir(cdir)):
            path = os.path.join(cdir, v)
            if os.path.isdir(path) or v.endswith(".npy"):
                items.append((path, li))
            elif v.lower().endswith(_VIDEO_EXT):
                if _decodable(path):
                    items.append((path, li))
                else:
                    skipped_raw += 1
    if skipped_raw:
        warnings.warn(
            f"{skipped_raw} raw video files skipped: no decode backend "
            "(install imageio+ffmpeg, or pre-extract the frames)")
    return items, classes


def _load_frames_u8(path: str, npy_range: str = "auto") -> np.ndarray:
    """-> (T0, H, W, 3) uint8; a uint8 `.npy` clip comes memory-mapped, so
    that only the frames a window reads are read from the file.

    `npy_range` fixes the value convention of FLOAT .npy clips for the
    whole dataset: "unit" = [0, 1], "symmetric" = [-1, 1], "auto" = per
    file, [-1, 1] where a value is negative (an all-non-negative [-1, 1]
    clip then reads as [0, 1]: a dataset with a known convention says so)."""
    if path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        if arr.dtype != np.uint8:
            a = arr.astype(np.float32)
            if npy_range == "symmetric" or (npy_range == "auto"
                                            and a.min() < 0.0):
                a = (a + 1.0) * 0.5
            arr = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        return arr
    if path.lower().endswith(_VIDEO_EXT):
        if not _decodable(path):
            raise RuntimeError(f"no video decode backend for {path}")
        return _video_reader()(path)
    return _decode_frames(path, _list_frame_files(path))


def _list_frame_files(path: str) -> list:
    frames = sorted(f for f in os.listdir(path)
                    if f.lower().endswith(_IMG_EXT))
    if not frames:
        raise ValueError(f"no frames in {path}")
    return frames


def _decode_frames(path: str, names: list) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: decoding frame images needs PIL, which this host does "
            f"not have; give the clips as .npy files (T, H, W, 3) instead"
        ) from e
    out = []
    for f in names:
        with Image.open(os.path.join(path, f)) as im:
            out.append(np.asarray(im.convert("RGB"), np.uint8))
    return np.stack(out)


class FrameFolderDataset:
    """Map-style dataset over extracted-frame directories and .npy clips."""

    def __init__(self, root: str, n_frames: int, img_size: int,
                 seed: int = 0, npy_range: str = "auto"):
        if npy_range not in ("auto", "unit", "symmetric"):
            raise ValueError(f"npy_range {npy_range!r}: must be auto | "
                             "unit | symmetric")
        self.items, self.classes = _list_videos(root)
        if not self.items:
            raise ValueError(f"no videos under {root}")
        self.n_frames = n_frames
        self.img_size = img_size
        self.seed = seed
        self.npy_range = npy_range
        self._epoch = 0

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    def __len__(self) -> int:
        return len(self.items)

    def set_epoch(self, epoch: int) -> None:
        """The epoch of the window draws (the loader calls this each epoch).
        A window is a pure function of (seed, epoch, index): a mid-epoch
        resume replays nothing stateful, and threads share no generator."""
        self._epoch = int(epoch)

    def __getitem__(self, idx: int):
        path, label = self.items[idx]
        t = self.n_frames
        # the window's start (a clip shorter than T wraps) from a generator
        # keyed by (seed, epoch, index), masked to 31 bits as Python ints
        rng = np.random.RandomState(
            (self.seed * 1000003 + self._epoch * 9973
             + idx * 101 + 17) & 0x7FFFFFFF)
        if os.path.isdir(path):
            # a frame directory: the start depends on the frame count only,
            # so only the window's frames are decoded
            names = _list_frame_files(path)
            t0 = len(names)
            start = rng.randint(0, t0 - t + 1) if t0 >= t else 0
            frames = _decode_frames(path, names[start:start + t])
            clip = native.clip_window(frames, t, self.img_size, 0)
        else:
            frames = _load_frames_u8(path, self.npy_range)
            t0 = frames.shape[0]
            start = rng.randint(0, t0 - t + 1) if t0 >= t else 0
            if t0 >= t:     # the window's frames alone: no wrap to keep
                frames, start = frames[start:start + t], 0
            # window, crop, resize and scaling in one pass
            clip = native.clip_window(frames, t, self.img_size, start)
        return clip, label
