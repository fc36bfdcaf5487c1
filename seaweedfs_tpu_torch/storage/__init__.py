"""Volume storage: needles, .idx/.dat files, volumes, disk locations, store."""
