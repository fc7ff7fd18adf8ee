"""Model and camera IO: PLY, cameras, PNG writing."""
