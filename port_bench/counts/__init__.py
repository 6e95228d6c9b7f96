"""The frozen operation and byte counts and the device's peaks: the
yardstick the rooflines and MFUs divide by."""
