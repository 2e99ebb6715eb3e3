"""PyTorch / CUDA port of svdformer_pointsea_tpu (point-cloud completion).

The JAX package is the reference; this package imports torch and numpy only.
Kernels written by hand for Hopper live in ``csrc/`` and are built and bound by
``kernels.py``. Ported so far: the PCN evaluation path (render -> SVDFormer ->
CD / DCD / F1, ``train.evaluate.eval_pcn``) and the PCN train step
(``train.build_model``, ``train.init_state``, ``train.make_train_step``).
"""
