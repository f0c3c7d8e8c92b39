"""The benchmark's own copies of the program's sound measuring code (each module names what it
was copied from): operation and byte counts, card peaks, the trace's reduction, load clients."""
