"""Volume I/O (numpy only)."""
