"""Pattern bank and detector of the port."""
