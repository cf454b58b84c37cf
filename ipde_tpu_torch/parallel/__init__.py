"""Several devices in one process: the port of ``ipde_tpu.parallel``."""
