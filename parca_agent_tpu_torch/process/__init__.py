"""Process mappings: the per-window mapping table built from each pid's
executable mappings (process/maps.py)."""
