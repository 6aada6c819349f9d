"""Core IR + executor (analog of paddle/fluid/framework/)."""
