"""The card's peak allocated memory over set-up and window."""

from benchmark import readers

read = readers.peak_mem_gib
