"""Steps per second over the window."""

from benchmark import readers

read = readers.steps_per_s
