"""Episode sources, normalizers and the sequence dataset (numpy)."""
