"""Linear system identification, the projection matrix, the analytical,
numerical and trajectory extractors, and the env registry (numpy; the
extractors step gymnasium envs on the host)."""
