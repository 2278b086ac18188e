"""Two-scan compare: ICP registration and the missing/damaged report."""
