"""Layer helpers (port); see ``attention``."""
