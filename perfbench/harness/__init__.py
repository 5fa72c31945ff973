"""The yardstick's shared pieces: loading cells by name, weights and
traffic from the seed, statistics, the device trace's reduction, the
chip's peaks and the comparison that decides ``correct``."""
