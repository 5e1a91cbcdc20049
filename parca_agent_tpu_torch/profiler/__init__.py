"""The window loop of the fast path (cpu.py) and its encode worker
(encode_pipeline.py)."""
