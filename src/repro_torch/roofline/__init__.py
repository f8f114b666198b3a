"""Roofline of the port: the device's constants (``hw``) and the analytic
per-step cost model (``analytic``)."""
