"""PyTorch + CUDA port of uncalled_tpu: the batch mappers and the realtime
ReadUntil path.

The package imports torch and numpy only.  Its entry points
(``PooledEngine``, ``MapEngine``, ``BatchMapper``, ``RealtimeMapper``,
``map_ordered``, ``device_index``) run on the CUDA card by default and
raise when none is present, unless the caller passes ``device="cpu"``; on
the CPU every hand-written kernel is replaced by its plain PyTorch
version, which is what the tests run.
"""
