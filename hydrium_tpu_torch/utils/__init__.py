"""Host utilities: encode statistics and the libjxl decode oracle."""
