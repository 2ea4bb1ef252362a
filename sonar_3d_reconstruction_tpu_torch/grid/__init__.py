"""Map state: the brick grid and its bucketed key table."""
