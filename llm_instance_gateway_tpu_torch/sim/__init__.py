"""Capacity-twin calibration over the port's engine (``calibrate.py``)."""
