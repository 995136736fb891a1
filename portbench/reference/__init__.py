"""The plain reference of DCNet and what it computes for each traffic."""
