"""Batch inference: arrays or image folders in, PNG masks out.

Counterpart of :mod:`emip_tpu.infer`. Short model: frame pairs are
batched through one device forward (:func:`predict_arrays`); in a process
group each rank predicts its share of the pairs (:func:`predict_pairs`).
Long model:
whole videos stream frame by frame with the memory carried
(:func:`predict_clips_long`). Decoding and the variable-shape
post-processing (bilinear resize to native size, sigmoid, min-max, PNG)
run on host threads. PIL is imported lazily. The folder entry points run
on the GPU unless the caller names another device.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from emip_tpu_torch.data import (
    ClipLoader,
    load_frame,
    scan_pairs,
    shard_order,
)
from emip_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from emip_tpu_torch.ops.image import linear_weights_np
from emip_tpu_torch.parallel import world

__all__ = ["predict_arrays", "predict_pairs", "predict_clips_long",
           "postprocess_to_png"]


@torch.inference_mode()
def predict_arrays(model, img1: torch.Tensor, img2: torch.Tensor):
    """NCHW frame batches on the model's device -> (mask logits
    [B, 1, H, W], forward flow [B, 2, H, W]), both fp32 whatever the
    model's compute dtype (as the JAX package's ``predict_arrays`` hands
    the host fp32)."""
    mask, flow_fw, _ = model(img1, img2)
    return mask.float(), flow_fw[-1].float()


def postprocess_to_png(logits_hw: np.ndarray, orig_hw, path: str) -> None:
    """logits [h, w] -> bilinear resize -> sigmoid -> min-max -> PNG."""
    from PIL import Image

    wh = linear_weights_np(logits_hw.shape[0], int(orig_hw[0]))
    ww = linear_weights_np(logits_hw.shape[1], int(orig_hw[1]))
    up = np.einsum("ph,hw->pw", wh, logits_hw.astype(np.float32))
    up = np.einsum("qw,pw->pq", ww, up)
    pred = 1.0 / (1.0 + np.exp(-up))
    pred = (pred - pred.min()) / (pred.max() - pred.min() + 1e-8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(pred * 255).convert("L").save(path)


def _batched(items, n):
    for i in range(0, len(items), n):
        yield items[i:i + n]


def predict_pairs(model, images_root: str, save_path: str, size: int = 352,
                  dataset_type: str = "MoCA", batch_size: int = 8,
                  device: torch.device | str = DEFAULT_DEVICE,
                  return_flow: bool = False):
    """Run the short model over every frame pair; save per-video PNGs.

    ``model`` must lie on ``device`` (default: the GPU; raises without
    one). The last batch is padded to ``batch_size`` by repeating its last
    pair. With ``return_flow``, returns [(video, frame_name, flow
    [H, W, 2])] of every pair in order.

    In a process group of more than one rank (the counterpart of the JAX
    package's sharding of the batch over the mesh's ``data`` axis) each
    rank predicts its share of the pairs, by
    :func:`emip_tpu_torch.data.shard_order` (the ``DistributedSampler``
    rule), in batches of ``batch_size`` padded as above, so that every
    forward has the one-process shapes. Each rank writes the PNGs of its
    share; a pair that the share's wrap padding repeats is predicted but
    written by its own rank alone, so the ranks' files together are the
    one-process set, each written once. With ``return_flow`` the flows are
    gathered: every rank returns the whole list (a collective).
    """
    device = resolve_device(device)
    items = scan_pairs(images_root, dataset_type)
    rank, ranks = world()
    # (index, pair) of this rank's share; an index past the items is the
    # wrap padding's repeat, predicted but not written
    share = list(enumerate(items))
    if ranks > 1:
        share = [(i if k * ranks + rank < len(items) else -1, items[i])
                 for k, i in enumerate(shard_order(list(range(len(items))),
                                                   rank, ranks))]
    results = []
    with ThreadPoolExecutor(8) as pool:
        for batch in _batched(share, batch_size):
            keep = [i >= 0 for i, _ in batch]
            chunk = [it for _, it in batch]
            n = len(chunk)
            frames = list(pool.map(
                lambda it: (load_frame(it.image1, size),
                            load_frame(it.image2, size)), chunk))
            img1 = np.stack([f[0][0] for f in frames])
            img2 = np.stack([f[1][0] for f in frames])
            if n < batch_size:
                pad = batch_size - n
                img1 = np.concatenate([img1, img1[-1:].repeat(pad, 0)])
                img2 = np.concatenate([img2, img2[-1:].repeat(pad, 0)])
            t1 = torch.from_numpy(img1.transpose(0, 3, 1, 2)).to(device)
            t2 = torch.from_numpy(img2.transpose(0, 3, 1, 2)).to(device)
            masks, flows = predict_arrays(model, t1, t2)
            masks = masks[:n, 0].float().cpu().numpy()
            jobs = [pool.submit(postprocess_to_png, logits, f[0][1],
                                os.path.join(save_path, it.video,
                                             it.frame_name + ".png"))
                    for it, logits, f, k in zip(chunk, masks, frames, keep)
                    if k]
            if return_flow:
                fl = flows[:n].permute(0, 2, 3, 1).float().cpu().numpy()
                results.extend((i, (it.video, it.frame_name, f))
                               for (i, it), f in zip(batch, fl) if i >= 0)
            for j in jobs:
                j.result()
    if return_flow and ranks > 1:
        import torch.distributed as dist

        every = [None] * ranks
        dist.all_gather_object(every, results)
        results = sorted(sum(every, []), key=lambda r: r[0])
    return [r for _, r in results]


@torch.inference_mode()
def predict_clips_long(model, images_root: str, save_path: str,
                       size: int = 352, dataset_type: str = "MoCA",
                       device: torch.device | str = DEFAULT_DEVICE) -> int:
    """Long-model streaming inference over whole videos; per-video PNGs.

    Protocol of the reference (test_long.py:29-37): frame 0 pairs with
    frame 1 and takes the short-term mask; later frames take the
    memory-prompted long head with the rolling buffer carried across
    steps (:meth:`EMIPLong.scan_video`, which encodes each frame once).
    ``model`` (an eval-mode ``EMIPLong``) must lie on ``device`` (default:
    the GPU; raises without one). Returns the number of frames predicted.
    """
    device = resolve_device(device)
    loader = ClipLoader(images_root, None, size=size,
                        dataset_type=dataset_type, with_gt=False)
    n = 0
    with ThreadPoolExecutor(8) as pool:
        for clip in loader:
            frames = torch.from_numpy(
                clip["frames"].transpose(0, 3, 1, 2)).to(device)
            logits = model.scan_video(frames[None])[0, :, 0]
            logits = logits.float().cpu().numpy()
            jobs = [pool.submit(postprocess_to_png, lg, clip["orig_hw"],
                                os.path.join(save_path, clip["video"],
                                             name + ".png"))
                    for lg, name in zip(logits, clip["frame_names"])]
            for j in jobs:
                j.result()
            n += len(frames)
    return n
