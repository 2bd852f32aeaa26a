"""Frame-pair listing, loading, augmentation and synthetic data (no jax).

Same directory rules as :mod:`emip_tpu.data.manifest` (which cannot be
imported without jax, because its package imports the JAX pipeline):

  <root>/<video>/<frames_subdir>/*.{jpg,png}   (sorted)
  <root>/<video>/GT/*.{png,tif}                (sorted)

pair i is (frame_i, frame_{i+1}), is named after frame_i and, where GT is
read, is supervised by GT_i (the last GT of each video is dropped); the
frames subdir is 'Imgs' for MoCA, 'frames' for CAD, 'Frame' for
pseudo-labeled MoCA. Preprocessing matches the JAX loader: PIL bilinear
resize to the square input size, [0, 1] scaling, ImageNet normalization;
GT resized the same way without normalization. The training
augmentations are those of :mod:`emip_tpu.data.augment` (joint rotation,
colour jitter, salt-and-pepper GT noise), seeded per item. Arrays are
NHWC numpy, as the JAX loaders yield them. PIL is imported lazily.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from emip_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["PairItem", "frames_subdir", "scan_pairs", "load_frame",
           "PairTrainLoader", "PairEvalLoader", "make_synthetic_video_root"]

_IMG_EXT = (".jpg", ".png")
_GT_EXT = (".png", ".tif")
_MEAN = np.asarray(IMAGENET_MEAN, np.float32)
_STD = np.asarray(IMAGENET_STD, np.float32)
_WORKERS = 8   # decode / augment threads per loader
_PREFETCH = 4  # train batches decoded ahead of the step


@dataclasses.dataclass(frozen=True)
class PairItem:
    image1: str
    image2: str
    video: str
    frame_name: str
    gt: str | None = None


def frames_subdir(dataset_type: str) -> str:
    if "CAD" in dataset_type:
        return "frames"
    if "pseudo" in dataset_type:
        return "Frame"
    return "Imgs"


def _list(dirpath: str, exts) -> list[str]:
    if not os.path.isdir(dirpath):
        return []
    return sorted(os.path.join(dirpath, f) for f in os.listdir(dirpath)
                  if f.lower().endswith(exts))


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def scan_pairs(images_root: str, dataset_type: str = "MoCA",
               gts_root: str | None = None) -> list[PairItem]:
    """Consecutive-frame pairs over all videos under ``images_root``; with
    ``gts_root``, each pair carries the GT of its first frame."""
    sub = frames_subdir(dataset_type)
    items = []
    for video in sorted(os.listdir(images_root)):
        frames = _list(os.path.join(images_root, video, sub), _IMG_EXT)
        if len(frames) < 2:
            continue
        gts = [None] * (len(frames) - 1)
        if gts_root is not None:
            gts = _list(os.path.join(gts_root, video, "GT"), _GT_EXT)[:-1]
            if len(gts) != len(frames) - 1:
                raise ValueError(f"{video}: {len(frames)} frames vs "
                                 f"{len(gts)} usable GTs")
        for a, b, gt in zip(frames, frames[1:], gts):
            if gt is not None and _stem(gt) != _stem(a):
                raise ValueError(f"frame/GT mismatch: {a} vs {gt}")
            items.append(PairItem(a, b, video, _stem(a), gt))
    return items


def _open(path: str, mode: str):
    from PIL import Image

    with open(path, "rb") as f:
        return Image.open(f).convert(mode)


def _to_norm_array(img, size: int) -> np.ndarray:
    from PIL import Image

    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return (np.asarray(img, np.float32) / 255.0 - _MEAN) / _STD


def _to_mask_array(img, size: int) -> np.ndarray:
    from PIL import Image

    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return (np.asarray(img, np.float32) / 255.0)[..., None]


def load_frame(path: str, size: int) -> tuple[np.ndarray, tuple[int, int]]:
    """-> (normalized [size, size, 3] float32 frame, original (h, w))."""
    img = _open(path, "RGB")
    return _to_norm_array(img, size), (img.height, img.width)


# ------------------------------------------------------- augmentation


def _joint_rotation(rng: random.Random, images, prob: float = 0.2,
                    max_deg: int = 15):
    from PIL import Image

    if rng.random() > 1.0 - prob:
        angle = rng.randint(-max_deg, max_deg - 1)
        images = [im.rotate(angle, Image.BICUBIC) for im in images]
    return images


def _color_jitter(rng: random.Random, image):
    from PIL import ImageEnhance

    image = ImageEnhance.Brightness(image).enhance(rng.randint(5, 15) / 10.0)
    image = ImageEnhance.Contrast(image).enhance(rng.randint(5, 15) / 10.0)
    image = ImageEnhance.Color(image).enhance(rng.randint(0, 20) / 10.0)
    return ImageEnhance.Sharpness(image).enhance(rng.randint(0, 30) / 10.0)


def _salt_pepper(rng: random.Random, mask, ratio: float = 0.0015):
    from PIL import Image

    arr = np.array(mask)
    n = int(ratio * arr.shape[0] * arr.shape[1])
    if n == 0:
        return mask
    np_rng = np.random.default_rng(rng.getrandbits(32))
    ys = np_rng.integers(0, arr.shape[0], n)
    xs = np_rng.integers(0, arr.shape[1], n)
    arr[ys, xs] = np_rng.integers(0, 2, n).astype(arr.dtype) * 255
    return Image.fromarray(arr)


class PairTrainLoader:
    """Shuffled, augmented, batched frame-pair loader with prefetch.

    Yields dicts of NHWC numpy arrays: ``image1``, ``image2`` [B, S, S, 3]
    and ``gt`` [B, S, S, 1]; the last short batch is dropped. Shuffling and
    augmentation are seeded by (seed, epoch, batch, item), as in the JAX
    loader.
    """

    def __init__(self, images_root: str, gts_root: str, batch_size: int,
                 size: int = 352, dataset_type: str = "MoCA",
                 seed: int = 123, augment: bool = True):
        self.items = scan_pairs(images_root, dataset_type, gts_root)
        self.batch_size = batch_size
        self.size = size
        self.seed = seed
        self.augment = augment
        self.epoch = 0

    def __len__(self):
        return len(self.items) // self.batch_size

    def _load_one(self, item: PairItem, rng: random.Random):
        img1, img2 = _open(item.image1, "RGB"), _open(item.image2, "RGB")
        gt = _open(item.gt, "L")
        if self.augment:
            img1, img2, gt = _joint_rotation(rng, [img1, img2, gt])
            img1 = _color_jitter(rng, img1)
            img2 = _color_jitter(rng, img2)
            gt = _salt_pepper(rng, gt)
        return (_to_norm_array(img1, self.size),
                _to_norm_array(img2, self.size),
                _to_mask_array(gt, self.size))

    def __iter__(self):
        self.epoch += 1
        order = list(range(len(self.items)))
        random.Random(f"{self.seed}:{self.epoch}").shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        batches = [b for b in batches if len(b) == self.batch_size]
        out: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        done = object()
        stop = threading.Event()

        def produce():
            with ThreadPoolExecutor(_WORKERS) as pool:
                for bi, idxs in enumerate(batches):
                    if stop.is_set():
                        break
                    rngs = [random.Random(f"{self.seed}:{self.epoch}:{bi}:{j}")
                            for j in range(len(idxs))]
                    res = list(pool.map(
                        lambda a: self._load_one(self.items[a[0]], a[1]),
                        zip(idxs, rngs)))
                    out.put(dict(image1=np.stack([r[0] for r in res]),
                                 image2=np.stack([r[1] for r in res]),
                                 gt=np.stack([r[2] for r in res])))
            out.put(done)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while (batch := out.get()) is not done:
                yield batch
        finally:
            # a consumer that stops early must not leave the producer
            # blocked on a full queue
            stop.set()
            while thread.is_alive():
                try:
                    out.get(timeout=0.1)
                except queue.Empty:
                    pass


class PairEvalLoader:
    """Sequential pair loader for validation: per-pair records with the
    normalized frames, the native-resolution GT (0..255) and the GT
    resized to the input size."""

    def __init__(self, images_root: str, gts_root: str, size: int = 352,
                 dataset_type: str = "MoCA"):
        self.items = scan_pairs(images_root, dataset_type, gts_root)
        self.size = size

    def __len__(self):
        return len(self.items)

    def _load_one(self, item: PairItem) -> dict:
        gt = _open(item.gt, "L")
        return dict(image1=load_frame(item.image1, self.size)[0],
                    image2=load_frame(item.image2, self.size)[0],
                    gt=np.asarray(gt, np.float32),
                    gt_resized=_to_mask_array(gt, self.size),
                    video=item.video, frame_name=item.frame_name)

    def __iter__(self):
        with ThreadPoolExecutor(_WORKERS) as pool:
            yield from pool.map(self._load_one, self.items)


# ------------------------------------------------------------ synthetic


def make_synthetic_video_root(root: str, num_videos: int = 2,
                              frames_per_video: int = 5,
                              size: tuple[int, int] = (96, 128),
                              seed: int = 0) -> str:
    """A dataset tree of random backgrounds with a moving bright blob (so
    both losses have signal), in the on-disk layout of MoCA.
    Counterpart of :func:`emip_tpu.data.synthetic.make_synthetic_video_root`;
    returns ``root`` with a trailing separator."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    sub = frames_subdir("MoCA")
    yy, xx = np.mgrid[0:h, 0:w]
    r = 10
    for v in range(num_videos):
        img_dir = os.path.join(root, f"video_{v:02d}", sub)
        gt_dir = os.path.join(root, f"video_{v:02d}", "GT")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)
        bg = rng.integers(0, 255, (h, w, 3), np.uint8)
        cy, cx = rng.integers(20, h - 20), rng.integers(20, w - 20)
        dy, dx = rng.integers(-3, 4), rng.integers(-3, 4)
        for t in range(frames_per_video):
            blob = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r
            frame = bg.copy()
            frame[blob] = (220, 220, 220)
            Image.fromarray(frame).save(os.path.join(img_dir, f"{t:05d}.jpg"),
                                        quality=95)
            Image.fromarray((blob * 255).astype(np.uint8)).save(
                os.path.join(gt_dir, f"{t:05d}.png"))
            cy = int(np.clip(cy + dy, r, h - r - 1))
            cx = int(np.clip(cx + dx, r, w - r - 1))
    return root if root.endswith(os.sep) else root + os.sep
