"""K-FAC health diagnostics for the port's trainers."""
