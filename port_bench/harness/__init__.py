"""The benchmark's harness: what every cell shares (finding a cell's files
by name, the measured window, the trace's arithmetic, the device's
description, the import guard). What belongs to one configuration, one
traffic mix or one per-layer metric lives in files of its own."""
