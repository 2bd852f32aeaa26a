"""Short-term training of the port (counterpart of :mod:`emip_tpu.train`).

``python -m emip_tpu_torch.train --config ...`` runs
:func:`emip_tpu_torch.train.loops.train_short` (see ``__main__.py``).
"""
