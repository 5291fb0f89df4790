"""Multi-device execution of the port (sharding.py)."""
