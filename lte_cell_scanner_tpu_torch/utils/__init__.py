"""Host utilities: the IT++ ``.it`` container, raw rtl_sdr files, and the
debug and profiling machinery."""
