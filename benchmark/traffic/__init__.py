"""Traffic kinds (one runner module each) and mixes (one data file each)."""
