"""Map and trajectory plots (matplotlib, imported when a plot is drawn)."""
