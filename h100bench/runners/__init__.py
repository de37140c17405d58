"""Cell runners, one module per kind of traffic; a cell's ``runner`` names one."""
