"""Core math of the port: kernel functions, APNC embedding, Lloyd."""
