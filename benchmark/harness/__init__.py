"""The general parts of the benchmark: lookup by name, the loops that drive
the program, the trace reader, the counts of work and the comparison."""
