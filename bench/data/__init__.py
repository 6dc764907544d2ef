"""The benchmark's own data makers: inputs made from the run's seed on the
device, handed alike to the port and to the reference."""
