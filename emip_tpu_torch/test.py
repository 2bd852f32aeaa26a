"""Short-term batch inference on the port: dump per-video PNG masks.

    python -m emip_tpu_torch.test --data MoCA_test=/data/MoCA \
        --save_path ./predictions --batch_size 8

Mirrors the repository's ``test.py`` for the JAX package. The repository
holds no checkpoint yet, so the model (pvt_v2_b5 at 352^2) runs on
seeded random weights; predictions are written to
``<save_path>/<dataset>/<video>/<frame>.png``. It runs on the GPU
(``--device``, default ``cuda``; without a GPU it raises) and on the CPU,
through the plain versions, only with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["main"]

SIZE = 352
SEED = 0


def parse_args(argv=None):
    from emip_tpu_torch.device import add_device_flag

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--save_path", default="./predictions")
    p.add_argument("--data", nargs="+", required=True, metavar="NAME=PATH",
                   help="datasets to predict, e.g. MoCA_test=/data/MoCA")
    p.add_argument("--batch_size", type=int, default=8)
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    from emip_tpu_torch.device import resolve_device
    from emip_tpu_torch.infer import predict_pairs
    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu_torch.models.init import seeded_init_

    args = parse_args(argv)
    device = resolve_device(args.device)
    model = EMIPShort(EMIPShortConfig(inp_size=SIZE))
    seeded_init_(model, SEED)
    model = model.to(device).eval()
    for spec in args.data:
        name, root = spec.split("=", 1)
        out = os.path.join(args.save_path, name)
        print(f">>> predicting {name} from {root} -> {out} on {device}")
        predict_pairs(model, root, out, size=SIZE,
                      dataset_type=name if "CAD" in name else "MoCA",
                      batch_size=args.batch_size, device=device)


if __name__ == "__main__":
    main()
