"""Host-side data staging of the port (numpy only)."""
