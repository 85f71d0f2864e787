from repro_torch.storage.btree import BTree, bulk_load
