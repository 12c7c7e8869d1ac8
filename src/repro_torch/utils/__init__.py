"""Small helpers: device selection and wall-clock timing."""
