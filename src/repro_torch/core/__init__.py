"""COALA core of the port: TSQR, the COALA solver, calibration, compression."""
