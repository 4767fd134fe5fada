"""Result files of the PyTorch port: in-sample CSVs, task locks and the
SQLite forecast shards with their merge and legacy CSV export."""
