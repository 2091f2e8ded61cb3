"""Data parallelism: device lists, process groups and host worker pools."""
