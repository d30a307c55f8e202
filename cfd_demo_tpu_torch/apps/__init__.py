"""Command-line apps of the port (↔ cfd_demo_tpu/apps/)."""
