"""User-facing entry points of the port (counterpart of panst3r_tpu/apps)."""
