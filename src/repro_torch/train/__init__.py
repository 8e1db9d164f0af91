"""Training of the port: AdamW with LR schedules, a single-device step with
the reference's bf16 compute cast and remat, and the int8 gradient
quantizer."""
