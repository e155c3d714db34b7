"""Open-set tools: the OOD threshold calibration."""
