"""Process address spaces: /proc/PID/maps parsing and caching, the
per-window mapping table (process/maps.py), and the object-file cache
that gives each mapping its build id and normalization base
(process/objectfile.py)."""
