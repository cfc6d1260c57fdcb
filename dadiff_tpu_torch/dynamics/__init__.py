"""Linear system identification and the projection matrix (numpy)."""
