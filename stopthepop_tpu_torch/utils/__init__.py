"""Device selection and test scenes."""
