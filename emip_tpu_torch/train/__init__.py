"""Training of the port (counterpart of :mod:`emip_tpu.train`).

``python -m emip_tpu_torch.train --config ...`` runs the short-term
:func:`emip_tpu_torch.train.loops.train_short` (see ``__main__.py``);
``python -m emip_tpu_torch.train_long --config ...`` the long-term
:func:`emip_tpu_torch.train.long.train_long`; ``python -m
emip_tpu_torch.train_static --config ... --data_root ...`` the static-image
pretraining :func:`emip_tpu_torch.train.static.train_static`.
"""
