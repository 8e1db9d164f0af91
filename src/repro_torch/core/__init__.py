"""COALA core of the port: TSQR, the COALA solver, calibration, compression,
adapters and adaptive ranks (the JAX package's exports but
``distributed_tsqr_r``, which waits with ``dist``)."""
from repro_torch.core.coala import (  # noqa: F401
    CoalaResult,
    coala_factors,
    coala_project,
    coala_alpha_factors,
    eym_truncate,
    mu_from_lambda,
    r_from_x,
    rsvd_left_singvecs,
    weighted_error,
    balanced_split,
)
from repro_torch.core.tsqr import (  # noqa: F401
    RStreamer,
    augment_r_with_mu,
    gram_chunked,
    qr_r,
    square_r,
    tsqr_sequential,
    tsqr_tree,
)
from repro_torch.core import baselines, theory  # noqa: F401
