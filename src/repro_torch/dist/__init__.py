"""``repro_torch.dist``: mesh sharding + distributed calibration subsystem
(port of ``repro/dist``). Submodules:

  * ``sharding``  — per-tensor sharding specs for params / train state /
                    batches / caches across every config in
                    ``repro_torch.configs``, and their DTensor placements
  * ``calibrate`` — data-parallel Gram-free COALA calibration (butterfly
                    TSQR reduction of per-rank R factors)
  * ``group``     — the ranks of a gloo group started from one caller (the
                    counterpart of the reference's fake host devices)

The reference's ``compat`` (a JAX version shim) has no counterpart.
"""
