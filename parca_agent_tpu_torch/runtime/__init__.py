"""Runtime edges of the agent: the window flight recorder (trace.py),
device telemetry (device_telemetry.py), per-pid quarantine
(quarantine.py), the device probe and fault record (device_health.py)
and actor supervision (supervisor.py)."""
