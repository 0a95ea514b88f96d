"""The yardstick: inputs, the plain reference, counts, trace reduction."""
