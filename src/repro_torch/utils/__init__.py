"""Shared utilities: the dry run's counts of collectives, FLOPs and bytes
(``hlo_analysis``) and roofline math (``roofline``)."""
