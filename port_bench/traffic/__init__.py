"""Traffic: the pattern pool and the closed-loop clients' draws, from data files."""
