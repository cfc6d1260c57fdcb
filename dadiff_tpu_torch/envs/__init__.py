"""Environment data used by the planner."""
