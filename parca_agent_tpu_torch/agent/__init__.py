"""Agent shell pieces: profile writers."""
