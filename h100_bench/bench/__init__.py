"""The yardstick: catalog, weights, traffic, counts, peaks and the
reading of the device trace.  Nothing here imports the program."""
