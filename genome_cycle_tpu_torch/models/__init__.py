"""Stage drivers: cell-cycle stage programs + structure transitions."""
