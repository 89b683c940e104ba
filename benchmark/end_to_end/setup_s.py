"""Process start to the first timed step."""

from benchmark import readers

read = readers.setup_s
