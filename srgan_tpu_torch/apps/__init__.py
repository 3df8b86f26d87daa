"""Applications of the port: coefficient, age, crowd and driving."""
