"""Training of the port: AdamW with LR schedules and a single-device step."""
