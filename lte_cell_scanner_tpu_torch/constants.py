"""Core LTE numerology used throughout the framework.

Behavioral contract mirrors the reference constants
(reference include/constants.h:32-35 and the 1.92 Msps working rate
programmed at src/CellSearch.cpp:380).
"""

# LTE reference sample rate (30.72 Msps).  All LTE timing is defined at this
# rate; the receiver works at FS_LTE/16 = 1.92 Msps.
FS_LTE = 30720000.0

# Working (programmed dongle) sample rate.
FS_WORK = FS_LTE / 16.0  # 1.92 Msps

# DFT size at the working rate: 6 RB x 12 subcarriers = 72 used + guards.
NFFT = 128

# Number of used subcarriers (excluding DC).
N_SC = 72

# PSS/SSS occupy the middle 62 subcarriers (excluding DC).
N_SC_PSS = 62

# Time-domain PSS length: 9-sample CP + 128-sample body.
PSS_TD_LEN = 137

# Samples per 10 ms frame / 5 ms half-frame at the working rate.
FRAME_LEN = 19200
HALF_FRAME_LEN = 9600

# Capture length: 80 ms so a full 40 ms MIB period is always contained
# (reference src/capbuf.cpp:35).
CAPLENGTH = 153600

# Cyclic-prefix lengths at the working rate.
CP_NORMAL_FIRST = 10   # first OFDM symbol of each slot
CP_NORMAL = 9
CP_EXTENDED = 32

# Maximum downlink bandwidth in resource blocks.
N_RB_MAXDL = 110

# Tracker health threshold (reference include/constants.h:35).
CELL_DROP_THRESHOLD = 400

# Delay-spread combining arm for incoherent PSS combining
# (reference src/CellSearch.cpp:484).
DS_COMB_ARM = 2

# PSS detection false-alarm design point: 10^-12 per lag cell
# (reference src/CellSearch.cpp:500).
THRESH1_N_NINES = 12

# SSS log-likelihood acceptance gate (reference src/CellSearch.cpp:528).
THRESH2_N_SIGMA = 3.0
