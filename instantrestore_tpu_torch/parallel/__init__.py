"""Training across processes and cards (``distributed.py``, the counterpart
of ``instantrestore_tpu/parallel/mesh.py``)."""
