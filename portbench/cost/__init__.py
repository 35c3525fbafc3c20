"""The benchmark's own count of what the solver step must move and compute,
from shapes alone, and the table of the chip's peaks."""
