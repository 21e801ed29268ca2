"""Search-path models: PSS/SSS tables, front end, peak search, SSS/FOE,
decode back half, and the cell search shell."""
