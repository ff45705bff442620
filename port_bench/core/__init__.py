"""What every cell of the harness shares: the manifest and the files it
names, the device record, seeded inputs, the trace reduction."""
