"""Host-side setup: partition and overlap decomposition (numpy)."""
