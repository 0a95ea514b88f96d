"""The entry points a configuration can drive, one module each."""
