"""Data: synthetic IDC-like patches, the IDC directory loader, batching."""
