"""Frame-pair, whole-clip and static-image listing, loading, augmentation,
precomputed-flow files and synthetic data (no jax).

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
horizontal / vertical flips and centre crop, colour jitter,
salt-and-pepper GT noise), seeded per item. Static-image pretraining reads
a flat COD10K-style tree (``<root>/Imgs/*.jpg`` + ``<root>/GT/*.png``,
:class:`StaticImageLoader`). Arrays are NHWC numpy, as the JAX loaders
yield them. PIL is imported lazily.
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

__all__ = ["PairItem", "ClipItem", "frames_subdir", "scan_pairs",
           "scan_clips", "load_frame", "shard_order", "PairTrainLoader", "PairEvalLoader",
           "ClipLoader", "StaticImageLoader", "read_flo", "write_flo",
           "PairFlowLoader", "make_synthetic_video_root",
           "make_synthetic_static_root"]

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


@dataclasses.dataclass(frozen=True)
class ClipItem:
    video: str
    frames: tuple[str, ...]
    gts: tuple[str, ...]
    frame_names: tuple[str, ...]


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


def scan_clips(images_root: str, gts_root: str | None = None,
               dataset_type: str = "MoCA",
               require_gt: bool = True) -> list[ClipItem]:
    """Whole-video clips (long-term training and inference): every video
    with at least two frames, with all of its GTs when ``require_gt``."""
    sub = frames_subdir(dataset_type)
    clips = []
    for video in sorted(os.listdir(images_root)):
        frames = _list(os.path.join(images_root, video, sub), _IMG_EXT)
        if len(frames) < 2:
            continue
        gts = ()
        if require_gt:
            if gts_root is None:
                raise ValueError("scan_clips: require_gt needs gts_root")
            gts = tuple(_list(os.path.join(gts_root, video, "GT"), _GT_EXT))
        clips.append(ClipItem(video, tuple(frames), gts,
                              tuple(_stem(f) for f in frames)))
    return clips


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


def _joint_hflip(rng: random.Random, images):
    from PIL import Image

    if rng.randint(0, 1) == 1:
        images = [im.transpose(Image.FLIP_LEFT_RIGHT) for im in images]
    return images


def _joint_vflip(rng: random.Random, images):
    from PIL import Image

    if rng.randint(0, 1) == 1:
        images = [im.transpose(Image.FLIP_TOP_BOTTOM) for im in images]
    return images


def _joint_random_crop(rng: random.Random, images, border: int = 30):
    """One centred crop of all images, each side up to ``border`` pixels
    shorter (the reference's flip-augmented dataset, dataset_aug.py)."""
    w, h = images[0].size
    cw = rng.randint(w - border, w - 1) if w > border else w
    ch = rng.randint(h - border, h - 1) if h > border else h
    region = ((w - cw) >> 1, (h - ch) >> 1, (w + cw) >> 1, (h + ch) >> 1)
    return [im.crop(region) for im in images]


def shard_order(order: list, index: int, count: int) -> list:
    """Per-process slice of an epoch order — DistributedSampler semantics.

    The reference shards its datasets across DDP ranks with
    ``torch.utils.data.DistributedSampler``: pad the (already shuffled)
    index list by wrapping to the front until it divides ``count``, then
    give rank ``index`` the strided slice ``padded[index::count]``. All
    ranks shuffle with the same seed, so the shards are disjoint (up to the
    wrap padding), cover every item and have one length. Counterpart of
    :func:`emip_tpu.data.pipeline.shard_order`.
    """
    if not 0 <= index < count:
        raise ValueError(f"shard index {index} not in [0, {count})")
    if not order:
        return []
    per = -(-len(order) // count)  # ceil
    pad = per * count - len(order)
    padded = list(order)
    while pad > 0:  # wrap (possibly multiple times for tiny datasets)
        padded += order[:pad]
        pad = per * count - len(padded)
    return padded[index::count]


def _sharded_len(n_items: int, shard) -> int:
    """Items of one epoch of a loader with ``shard`` (or None)."""
    if shard is None:
        return n_items
    return len(shard_order(list(range(n_items)), *shard))


def _epoch_order(n_items: int, seed: int, epoch: int, shard,
                 shuffle: bool = True) -> list[int]:
    """The epoch's item order, shuffled by (seed, epoch) (unless
    ``shuffle`` is off), then this process's shard of it."""
    order = list(range(n_items))
    if shuffle:
        random.Random(f"{seed}:{epoch}").shuffle(order)
    return order if shard is None else shard_order(order, *shard)


def _check_shard(shard, drop_remainder: bool = True):
    """A sharded batched loader must drop the remainder: a short last
    batch could then differ in rows across processes (the JAX loaders'
    rule)."""
    if shard is not None and not drop_remainder:
        raise ValueError("shard requires drop_remainder=True (equal "
                         "per-process batches)")
    return shard


def _epoch_batches(n_items: int, batch_size: int, seed: int, epoch: int,
                   drop_remainder: bool = True,
                   shard=None) -> list[list[int]]:
    """The epoch's shuffled item order, this process's ``shard`` of it,
    cut into batches (a short last one dropped unless ``drop_remainder``
    is off), as the JAX loaders do."""
    order = _epoch_order(n_items, seed, epoch, shard)
    batches = [order[i:i + batch_size]
               for i in range(0, len(order), batch_size)]
    return [b for b in batches
            if len(b) == batch_size or not drop_remainder]


def _item_rngs(seed: int, epoch: int, bi: int, n: int) -> list:
    """One ``random.Random`` per item of batch ``bi``."""
    return [random.Random(f"{seed}:{epoch}:{bi}:{j}") for j in range(n)]


class PairTrainLoader:
    """Shuffled, augmented, batched frame-pair loader with prefetch.

    Yields dicts of NHWC numpy arrays: ``image1``, ``image2`` [B, S, S, 3]
    and ``gt`` [B, S, S, 1]; the last short batch is dropped. Shuffling and
    augmentation are seeded by (seed, epoch, batch, item), as in the JAX
    loader. ``flip_augment`` adds the joint horizontal and vertical flips
    of the reference's flip-augmented dataset after the rotation.
    ``shard`` = (index, count) gives this process its slice of each
    shuffled epoch (:func:`shard_order`); the batch index of the item RNGs
    counts within the shard, as in the JAX loader.
    """

    def __init__(self, images_root: str, gts_root: str, batch_size: int,
                 size: int = 352, dataset_type: str = "MoCA",
                 seed: int = 123, augment: bool = True,
                 flip_augment: bool = False,
                 shard: tuple[int, int] | None = None):
        self.items = scan_pairs(images_root, dataset_type, gts_root)
        self.batch_size = batch_size
        self.size = size
        self.seed = seed
        self.augment = augment
        self.flip_augment = flip_augment
        self.shard = _check_shard(shard)
        self.epoch = 0

    def __len__(self):
        return _sharded_len(len(self.items), self.shard) // self.batch_size

    def _load_one(self, item: PairItem, rng: random.Random):
        img1, img2 = _open(item.image1, "RGB"), _open(item.image2, "RGB")
        gt = _open(item.gt, "L")
        if self.augment:
            img1, img2, gt = _joint_rotation(rng, [img1, img2, gt])
            if self.flip_augment:
                img1, img2, gt = _joint_hflip(rng, [img1, img2, gt])
                img1, img2, gt = _joint_vflip(rng, [img1, img2, gt])
            img1 = _color_jitter(rng, img1)
            img2 = _color_jitter(rng, img2)
            gt = _salt_pepper(rng, gt)
        return (_to_norm_array(img1, self.size),
                _to_norm_array(img2, self.size),
                _to_mask_array(gt, self.size))

    def __iter__(self):
        self.epoch += 1
        batches = _epoch_batches(len(self.items), self.batch_size, self.seed,
                                 self.epoch, shard=self.shard)
        out: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        done = object()
        stop = threading.Event()

        def produce():
            with ThreadPoolExecutor(_WORKERS) as pool:
                for bi, idxs in enumerate(batches):
                    if stop.is_set():
                        break
                    rngs = _item_rngs(self.seed, self.epoch, bi, len(idxs))
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


class ClipLoader:
    """Whole-video loader of the long-term model: one element per video,
    a dict with ``video``, ``frames`` [T, S, S, 3] (normalized),
    ``frame_names``, ``orig_hw`` (frame 0's native size) and, with GT, ``masks`` [T, S, S, 1] at the model's
    resolution and ``gts``, the native-resolution GTs (0..255). No
    augmentation; ``shuffle`` orders the videos by (seed, epoch), as the
    JAX loader does, and ``shard`` = (index, count) then gives this process
    its slice of that order (:func:`shard_order`)."""

    def __init__(self, images_root: str, gts_root: str | None = None,
                 size: int = 352, dataset_type: str = "MoCA",
                 with_gt: bool = True, shuffle: bool = False,
                 seed: int = 123, shard: tuple[int, int] | None = None):
        self.clips = scan_clips(images_root, gts_root, dataset_type,
                                require_gt=with_gt)
        self.size = size
        self.with_gt = with_gt
        self.shuffle = shuffle
        self.seed = seed
        self.shard = shard
        self.epoch = 0

    def __len__(self):
        return _sharded_len(len(self.clips), self.shard)

    def load_clip(self, clip: ClipItem) -> dict:
        with ThreadPoolExecutor(_WORKERS) as pool:
            loaded = list(pool.map(lambda p: load_frame(p, self.size),
                                   clip.frames))
        rec = dict(video=clip.video,
                   frames=np.stack([arr for arr, _ in loaded]),
                   frame_names=clip.frame_names, orig_hw=loaded[0][1])
        if self.with_gt and clip.gts:
            gts = [_open(p, "L") for p in clip.gts]
            rec["masks"] = np.stack([_to_mask_array(g, self.size)
                                     for g in gts])
            rec["gts"] = [np.asarray(g, np.float32) for g in gts]
        return rec

    def __iter__(self):
        self.epoch += 1
        for i in _epoch_order(len(self.clips), self.seed, self.epoch,
                              self.shard, self.shuffle):
            yield self.load_clip(self.clips[i])


class StaticImageLoader:
    """Flat image / GT loader of static-image pretraining.

    COD10K-style tree: ``<root>/Imgs/*.jpg`` (or ``Image/``, ``Images/``)
    and ``<root>/GT/<stem>.png``; an image without its GT is left out.
    Yields dicts of NHWC numpy arrays, ``image`` [B, S, S, 3] (normalized)
    and ``gt`` [B, S, S, 1] in [0, 1]. Shuffling and augmentation (joint
    rotation, joint horizontal flip, colour jitter, GT salt-and-pepper)
    are seeded by (seed, epoch, batch, item), so the batches are those of
    :class:`emip_tpu.data.pipeline.StaticImageLoader` bit for bit. With
    ``drop_remainder`` off, the last short batch is kept. ``shard`` =
    (index, count) gives this process its slice of each shuffled epoch
    (:func:`shard_order`; it requires ``drop_remainder``).
    """

    def __init__(self, root: str, batch_size: int, size: int = 352,
                 seed: int = 123, augment: bool = True,
                 drop_remainder: bool = True,
                 shard: tuple[int, int] | None = None):
        self.shard = _check_shard(shard, drop_remainder)
        img_dir = next((os.path.join(root, c) for c in
                        ("Imgs", "Image", "Images")
                        if os.path.isdir(os.path.join(root, c))), None)
        if img_dir is None:
            raise FileNotFoundError(f"no Imgs/, Image/ or Images/ under "
                                    f"{root}")
        self.items = []
        for img in _list(img_dir, _IMG_EXT):
            gt = os.path.join(root, "GT", _stem(img) + ".png")
            if os.path.isfile(gt):
                self.items.append((img, gt))
        self.batch_size = batch_size
        self.size = size
        self.seed = seed
        self.augment = augment
        self.drop_remainder = drop_remainder
        self.epoch = 0

    def __len__(self):
        n, rest = divmod(_sharded_len(len(self.items), self.shard),
                         self.batch_size)
        return n + int(bool(rest) and not self.drop_remainder)

    def _load_one(self, idx: int, rng: random.Random):
        img_path, gt_path = self.items[idx]
        img, gt = _open(img_path, "RGB"), _open(gt_path, "L")
        if self.augment:
            img, gt = _joint_rotation(rng, [img, gt])
            img, gt = _joint_hflip(rng, [img, gt])
            img = _color_jitter(rng, img)
            gt = _salt_pepper(rng, gt)
        return _to_norm_array(img, self.size), _to_mask_array(gt, self.size)

    def __iter__(self):
        self.epoch += 1
        batches = _epoch_batches(len(self.items), self.batch_size, self.seed,
                                 self.epoch, self.drop_remainder, self.shard)
        with ThreadPoolExecutor(_WORKERS) as pool:
            for bi, idxs in enumerate(batches):
                rngs = _item_rngs(self.seed, self.epoch, bi, len(idxs))
                res = list(pool.map(lambda a: self._load_one(*a),
                                    zip(idxs, rngs)))
                yield dict(image=np.stack([r[0] for r in res]),
                           gt=np.stack([r[1] for r in res]))


# ------------------------------------------------- precomputed flow files

_FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Middlebury ``.flo`` -> [H, W, 2] float32 (x, y)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)[0]
        if magic != np.float32(_FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, 2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    """[H, W, 2] flow -> Middlebury ``.flo`` (float32)."""
    h, w, c = flow.shape
    if c != 2:
        raise ValueError(f"flow has {c} channels, not 2")
    with open(path, "wb") as f:
        np.float32(_FLO_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.astype(np.float32).tofile(f)


class PairFlowLoader:
    """Frame pairs with their precomputed flow, in order (counterpart of
    :class:`emip_tpu.data.flow_files.PairFlowLoader`, the reference's
    ``dataset/dataset_flow_jpg.py``).

    The flow of a pair is ``<video>/Flow/<frame>.flo`` (``flow``, [H, W, 2]
    float32) or a colour-wheel ``.jpg`` / ``.png`` (``flow_rgb``, uint8
    RGB); a pair without one yields neither key.
    """

    def __init__(self, images_root: str, gts_root: str, size: int = 352,
                 dataset_type: str = "MoCA"):
        self.items = scan_pairs(images_root, dataset_type, gts_root)
        self.size = size

    @staticmethod
    def _flow_path(item: PairItem) -> str | None:
        flow_dir = os.path.join(os.path.dirname(os.path.dirname(item.image1)),
                                "Flow")
        for ext in (".flo", ".jpg", ".png"):
            p = os.path.join(flow_dir, item.frame_name + ext)
            if os.path.isfile(p):
                return p
        return None

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        for item in self.items:
            rec = dict(image1=load_frame(item.image1, self.size)[0],
                       image2=load_frame(item.image2, self.size)[0],
                       gt=_to_mask_array(_open(item.gt, "L"), self.size),
                       video=item.video, frame_name=item.frame_name)
            fp = self._flow_path(item)
            if fp is not None and fp.endswith(".flo"):
                rec["flow"] = read_flo(fp)
            elif fp is not None:
                rec["flow_rgb"] = np.asarray(_open(fp, "RGB"), np.uint8)
            yield rec


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


def make_synthetic_static_root(root: str, num_images: int = 8,
                               size: tuple[int, int] = (96, 128),
                               seed: int = 0) -> str:
    """A COD10K-style flat ``Imgs/`` + ``GT/`` tree of random backgrounds,
    each with one bright blob. Counterpart of
    :func:`emip_tpu.data.synthetic.make_synthetic_static_root` (the same
    files for the same seed); returns ``root``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    img_dir = os.path.join(root, "Imgs")
    gt_dir = os.path.join(root, "GT")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(num_images):
        bg = rng.integers(0, 255, (h, w, 3), np.uint8)
        cy, cx, r = rng.integers(15, h - 15), rng.integers(15, w - 15), 10
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r
        frame = bg.copy()
        frame[blob] = (230, 230, 230)
        Image.fromarray(frame).save(os.path.join(img_dir, f"im_{i:04d}.jpg"),
                                    quality=95)
        Image.fromarray((blob * 255).astype(np.uint8)).save(
            os.path.join(gt_dir, f"im_{i:04d}.png"))
    return root
