"""Runtime edges of the agent: the window trace hooks (trace.py)."""
