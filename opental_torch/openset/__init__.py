"""Open-set tools: the OOD threshold calibration, OpenMax and its libmr
binding."""
