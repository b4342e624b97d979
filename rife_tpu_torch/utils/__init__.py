"""Host-side utilities: metric logging and the device-time breakdown."""
